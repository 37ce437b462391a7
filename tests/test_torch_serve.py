"""The port's serving front end against the JAX package's: ``run_trace`` on
the same trace and weights gives the same per-request outputs, and the
``serve`` CLI runs on the CPU only when asked — pipelined by default, open
loop with ``--arrivals``, the sustained-load gate with ``--sustained``,
traced with ``--trace-out`` — and refuses what is not ported."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serving.traces import get_trace as ref_get_trace  # noqa: E402

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402
from repro_torch.serving.traces import get_trace  # noqa: E402

ARCH = "qwen3-0.6b"
ECFG = dict(device_pool_pages=12, host_pool_pages=64, max_batch_tokens=256,
            policy="neo", pipeline=False, hw_profile="h100_sxm", ewma_alpha=0.0)


def test_run_trace_matches_reference():
    cfg_ref = ref_smoke(ARCH)
    params = ref_get_model(cfg_ref).init(jax.random.key(5))
    ref = RefEngine(cfg_ref, RefEngineConfig(**ECFG), params=params)
    m_ref = ref_serve.run_trace(
        ref, ref_serve._clamp_trace(ref_get_trace("osc", 5, 32.0, 3), 256, 6),
        vocab=cfg_ref.vocab_size, seed=3)
    cfg = get_smoke_config(ARCH)
    port = NeoEngine(cfg, EngineConfig(**ECFG), device="cpu",
                     params=params_from_reference(jax.tree.map(np.asarray, params), cfg))
    m_port = serve.run_trace(port, serve._clamp_trace(get_trace("osc", 5, 32.0, 3), 256, 6),
                             vocab=cfg.vocab_size, seed=3)
    ref.close()
    port.close()
    want = {rid: r.out_tokens for rid, r in ref.requests.items()}
    got = {rid: r.out_tokens for rid, r in port.requests.items()}
    assert got == want and len(got) == 5
    assert [(r.prompt_len, r.output_len) for r in m_port.records] == \
        [(r.prompt_len, r.output_len) for r in m_ref.records]
    assert m_port.summary()["terminal_counts"]["finished"] == 5


def test_cli_runs_on_cpu_when_asked(capsys):
    rc = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--no-pipeline",
                     "--n", "3", "--rate", "64", "--device-pages", "12",
                     "--host-pages", "32", "--max-batch-tokens", "128"])
    assert rc == 0
    assert '"requests": 3' in capsys.readouterr().out


@pytest.mark.parametrize("arch,mode", [("rwkv6-7b", "gpu_only"), ("zamba2-7b", "asym")])
def test_cli_serves_contiguous_families_on_cpu(arch, mode, capsys):
    """The contiguous engine behind the same CLI; the pool flags do not apply
    to it and are taken and ignored, as the reference's launcher does."""
    rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--no-pipeline",
                     "--n", "3", "--rate", "64", "--device-pages", "12",
                     "--host-pages", "32", "--max-batch-tokens", "128"])
    assert rc == 0
    out = capsys.readouterr().out
    assert '"requests": 3' in out and f"scheduler modes: {{'{mode}'" in out


# Each of these was refused before the pipelined engine and the open-loop
# runner were ported; each now runs.
@pytest.mark.parametrize("flags,expect", [
    ([], ['"planahead_hits": ', "pipeline=True"]),
    (["--arrivals", "poisson"], ["arrivals=poisson"]),
    (["--sustained"], ['"bitwise_identical": true', '"planahead_hits_gt0": true']),
    (["--no-microbatch"], ['"microbatched_steps": 0', "microbatch=False"]),
    (["--max-host-lanes", "2"], ['"requests": 3']),
    (["--no-planahead"], ['"planahead_hits": 0,', "planahead=False"]),
    (["--slo-ttft", "5"], ['"requests": 3']),
    (["--slo-tpot", "0.5"], ['"requests": 3']),
])
def test_cli_runs_pipelined_and_open_loop_on_cpu(flags, expect, capsys):
    rc = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--n", "3",
                     "--rate", "64", "--device-pages", "12", "--host-pages", "32",
                     "--max-batch-tokens", "128", *flags])
    out = capsys.readouterr().out
    for text in expect:
        assert text in out, text
    if "--sustained" in flags:
        assert rc == (0 if '"pass": true' in out else 1)
    else:
        assert rc == 0 and '"finished": 3' in out


# Refused before the tracer was ported; each path now traces, exports and
# passes the reconcile audit.
@pytest.mark.parametrize("arch,flags", [
    (ARCH, ["--no-pipeline"]),
    (ARCH, ["--arrivals", "poisson"]),
    ("rwkv6-7b", ["--no-pipeline"]),
])
def test_cli_traces_and_reconciles_on_cpu(arch, flags, tmp_path, capsys):
    trace, counters = tmp_path / "t.json", tmp_path / "t.counters.jsonl"
    rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--n", "3",
                     "--rate", "64", "--device-pages", "12", "--host-pages", "32",
                     "--max-batch-tokens", "128", "--trace-out", str(trace),
                     "--require-reconcile", *flags])
    out = capsys.readouterr().out
    assert rc == 0 and '"finished": 3' in out
    summary = json.loads(out[out.index("{"): out.index("scheduler modes:")])
    assert summary["reconcile"]["ok"] and summary["reconcile"]["failed"] == []
    doc = json.loads(trace.read_text())
    assert doc["otherData"]["events_dropped"] == 0
    assert any(e.get("name") == "step" for e in doc["traceEvents"])
    assert counters.read_text().count("\n") > 0


@pytest.mark.parametrize("flags,item", [
    (["--prefix-cache"], "P9"),
    (["--tp", "2"], "P13"),
    (["--spec-decode"], "P10"),
    (["--spec-k", "2"], "P10"),
])
def test_cli_refuses_unported_options(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", *flags])
