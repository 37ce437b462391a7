"""The port's serving front end against the JAX package's: ``run_trace`` on
the same trace and weights gives the same per-request outputs, and the
``serve`` CLI runs on the CPU only when asked — pipelined by default, open
loop with ``--arrivals``, the sustained-load gate with ``--sustained``,
traced with ``--trace-out``, the prefix cache with ``--prefix-cache`` and its
gates — and refuses what is not ported."""

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_config as ref_full  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core import engine as ref_engine_mod  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serving.traces import get_trace as ref_get_trace  # noqa: E402

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
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


def _virtual_clock(dt):
    """A ``time`` stand-in whose clock advances ``dt`` per reading (and by
    the slept time), so ``run_trace`` submits each request at the same loop
    turn on both sides whatever the host's speed."""
    now = [0.0]

    def perf_counter():
        now[0] += dt
        return now[0]

    def sleep(s):
        now[0] += s

    return types.SimpleNamespace(perf_counter=perf_counter, sleep=sleep, time=perf_counter)


class _FrozenConfig:
    """An EngineConfig factory with the perf model frozen (``ewma_alpha=0``)
    and one hardware profile, so both launchers plan alike."""

    def __init__(self, cls):
        self.cls = cls

    def __call__(self, **kw):
        return self.cls(**{**kw, "ewma_alpha": 0.0, "hw_profile": "h100_sxm"})

    def __getattr__(self, name):
        return getattr(self.cls, name)


PREFIX_KEYS = ("prefill_tokens_computed", "hit_rate", "prefix_hit_tokens", "prefix_hits",
               "prefix_lookups", "prefix_promoted_pages", "prefix_demoted_pages",
               "prefix_evicted_pages", "prefix_cow_copies", "inplace_host_hits",
               "host_served_hit_tokens", "host_hit_pcie_MB")


def test_cli_prefix_cache_matches_reference(monkeypatch, capsys):
    """``--prefix-cache --require-hits --host-serving`` on the multiturn
    trace (refused before the cache was ported) exits 0, with every gate
    held, and its summary's prefix-cache keys equal the reference
    launcher's on the same arguments (virtual arrival clock, frozen perf
    model on both sides)."""
    args = ["--smoke", "--trace", "multiturn", "--prefix-cache", "--require-hits",
            "--host-serving"]
    summaries = {}
    for side, mod in (("ref", ref_serve), ("port", serve)):
        monkeypatch.setattr(mod, "time", _virtual_clock(0.05))
        monkeypatch.setattr(mod, "EngineConfig", _FrozenConfig(mod.EngineConfig))
        rc = mod.main(args + (["--device", "cpu"] if side == "port" else []))
        out = capsys.readouterr().out
        assert rc == 0, out[-2000:]
        assert "host-serving OK" in out
        summaries[side] = json.loads(out[out.index("{"): out.index("scheduler modes:")])
    got = {k: summaries["port"][k] for k in PREFIX_KEYS}
    assert got == {k: summaries["ref"][k] for k in PREFIX_KEYS}
    assert got["inplace_host_hits"] > 0 and got["prefix_cow_copies"] > 0
    assert summaries["port"]["terminal_counts"]["finished"] == 16


def _plan_at_full_width(monkeypatch, mod, engine_module, full):
    """Run ``mod``'s ``--smoke`` CLI planned as at full width: the engine's
    perf model and scheduler see ``full`` while the model keeps the smoke
    depth and width, with ``full``'s vocabulary so that the trace's prompts
    are the full-width run's (the schedule does not depend on the tokens)."""
    perf_for_arch = engine_module.PerfModel.for_arch
    scheduler = engine_module.NeoScheduler
    monkeypatch.setattr(engine_module.PerfModel, "for_arch",
                        lambda cfg, *a, **k: perf_for_arch(full, *a, **k))
    monkeypatch.setattr(engine_module, "NeoScheduler",
                        lambda cfg, *a, **k: scheduler(full, *a, **k))
    smoke = mod.get_smoke_config
    monkeypatch.setattr(mod, "get_smoke_config",
                        lambda arch: smoke(arch).replace(vocab_size=full.vocab_size))


@pytest.mark.parametrize("dt,want_rc", [(0.03, 1), (0.05, 0)])
def test_cli_prefix_cache_full_width_schedule_matches_reference(monkeypatch, capsys, dt,
                                                                want_rc):
    """``--prefix-cache --require-hits --host-serving`` at the CLI's default
    pools, planned as for full-width qwen3-0.6b (smoke weights), on a
    virtual arrival clock with the perf model frozen: the port's summary
    equals the reference's, exit code included.  Whether the host-serving
    gate holds depends on the clock, on the reference as on the port: at
    0.05 s a reading the hits are served in place; at 0.03 s (a faster
    loop against the same arrivals) no hit is, and the gate fails."""
    args = ["--smoke", "--trace", "multiturn", "--prefix-cache", "--require-hits",
            "--host-serving"]
    summaries, rcs = {}, {}
    for side, mod, eng_mod, full in (("ref", ref_serve, ref_engine_mod, ref_full(ARCH)),
                                     ("port", serve, engine_mod, get_config(ARCH))):
        _plan_at_full_width(monkeypatch, mod, eng_mod, full)
        monkeypatch.setattr(mod, "time", _virtual_clock(dt))
        monkeypatch.setattr(mod, "EngineConfig", _FrozenConfig(mod.EngineConfig))
        rcs[side] = mod.main(args + (["--device", "cpu"] if side == "port" else []))
        out = capsys.readouterr().out
        summaries[side] = json.loads(out[out.index("{"): out.index("scheduler modes:")])
    keys = PREFIX_KEYS + ("planahead_hits", "planahead_replans", "planahead_skipped")
    got = {k: summaries["port"][k] for k in keys}
    assert got == {k: summaries["ref"][k] for k in keys}
    assert rcs == {"ref": want_rc, "port": want_rc}
    assert (got["inplace_host_hits"] > 0) == (want_rc == 0)
    assert summaries["port"]["terminal_counts"]["finished"] == 16


@pytest.mark.parametrize("flags,exc,match", [
    (["--tp", "3"], ValueError, "must divide"),
    (["--arch", "internvl2-1b", "--tp", "2", "--spec-decode"], NotImplementedError,
     "dense family only"),
    (["--arch", "deepseek-moe-16b", "--tp", "2"], NotImplementedError, "dense family only"),
])
def test_cli_refuses_unported_options(flags, exc, match):
    """What the reference's CLI refuses, the port's refuses with its
    exception: ``--tp`` beyond the dense family, or not dividing the heads
    (``--tp 2`` on the dense family, refused here until tensor parallelism
    was ported, serves: tests/test_torch_tp.py; ``--spec-decode`` and
    ``--spec-k`` run: test_cli_spec_decode_*; the moe family serves:
    test_cli_serves_moe_vlm_and_audio_on_cpu)."""
    with pytest.raises(exc, match=match):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", *flags])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "internvl2-1b", "seamless-m4t-medium"])
def test_cli_serves_moe_vlm_and_audio_on_cpu(arch, capsys):
    """The CLI serves the moe and vlm families (paged; the vlm text only,
    as the reference's CLI) and the audio family (contiguous, each request
    with the seeded frames of the stubbed frontend) to the end."""
    rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--n", "3",
                     "--device-pages", "16", "--host-pages", "64", "--max-batch-tokens", "128"])
    summary = _summary(capsys.readouterr().out)
    assert rc == 0 and summary["terminal_counts"]["finished"] == 3


SPEC_ARGS = ["--arch", ARCH, "--smoke", "--device", "cpu", "--trace", "osc", "--n", "12",
             "--rate", "2", "--policy", "fastdecode"]


def _summary(out):
    return json.loads(out[out.index("{"): out.index("scheduler modes:")])


def test_cli_spec_decode_require_accepts(capsys):
    """``--spec-decode --spec-k 4 --require-accepts`` on the repetitive osc
    trace exits 0 with accepted drafts; the summary mirrors the engine's
    speculation counters and the ``spec:`` line prints them."""
    assert serve.main(SPEC_ARGS + ["--spec-decode", "--spec-k", "4",
                                   "--require-accepts"]) == 0
    out = capsys.readouterr().out
    s = _summary(out)
    assert s["spec_steps"] > 0 and s["accepted_tokens"] > 0
    assert s["rejected_drafts"] == s["drafted_tokens"] - s["accepted_tokens"]
    assert sum(int(k) * v for k, v in s["accept_len_hist"].items()) == s["accepted_tokens"]
    line = next(x for x in out.splitlines() if x.startswith("[serve] spec:"))
    assert f"accepted={s['accepted_tokens']}" in line and "spec=True" in out


def test_cli_spec_decode_require_accepts_fails_on_zero_accepts(monkeypatch, capsys):
    """``--require-accepts`` exits 1 when nothing was accepted."""
    class Never:
        def __init__(self, n):
            pass

        def propose(self, tokens, k):
            return [0] * k if tokens[-1] != 0 else [1] * k

    monkeypatch.setattr(engine_mod, "NgramDrafter", Never)
    assert serve.main(SPEC_ARGS + ["--n", "3", "--spec-decode", "--require-accepts"]) == 1
    out = capsys.readouterr().out
    assert "accepted 0 drafted tokens" in out and _summary(out)["drafted_tokens"] > 0


def test_cli_draft_model(capsys):
    """``--draft-model qwen3-0.6b`` (smoke, seeded ``--seed + 1``) implies
    ``--spec-decode``: drafts come from the draft model, tokens are those
    of speculation off."""
    args = SPEC_ARGS + ["--n", "4", "--max-batch-tokens", "256"]
    assert serve.main(args) == 0
    off = _summary(capsys.readouterr().out)
    assert serve.main(args + ["--draft-model", "qwen3-0.6b"]) == 0
    out = capsys.readouterr().out
    assert "[serve] draft model: qwen3-0.6b-smoke (window=64)" in out and "spec=True" in out
    on = _summary(out)
    assert on["spec_steps"] > 0 and on["drafted_tokens"] > 0
    assert on["terminal_counts"] == off["terminal_counts"]
    assert on["throughput_tok_s"] > 0


def test_cli_draft_model_vocab_mismatch_fails(capsys):
    """A draft model whose vocabulary is not the target's (full configs:
    yi-9b's 64,000 against qwen3-0.6b's 151,936) is refused with the
    reference's message before any model is built (the smoke configs all
    share one vocabulary)."""
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--draft-model", "yi-9b"]) == 1
    out = capsys.readouterr().out
    assert "[serve] FAIL: draft vocab 64000 != target vocab 151936 (token ids are proposed " \
        "verbatim)" in out


def test_sustained_virtual_clock_schedule(monkeypatch):
    """The schedule ``tests/test_torch_decode_invariance_card.py::
    test_card_sustained_divergence_record`` pins on the card: ``--sustained``
    at full width (16 osc requests at 4 req/s, pools 64/256), planned as for
    full-width qwen3-0.6b on smoke weights, perf model frozen, arrivals on
    virtual clocks of 0.05 s a reading (closed loop) and 0.04 s (open loop).
    The schedule does not depend on the tokens, so this derives the card's:
    5 requests' residency differs between the loops, each from the token
    given here; with one step for both loops none would differ."""
    _plan_at_full_width(monkeypatch, serve, engine_mod, get_config(ARCH))
    monkeypatch.setattr(serve, "EngineConfig", _FrozenConfig(serve.EngineConfig))
    steps, where, made = {"closed": 0.05, "open": 0.04}, [], []
    clock = types.SimpleNamespace(now=0.0, dt=0.0)

    def perf_counter():
        clock.now += clock.dt
        return clock.now

    def sleep(s):
        clock.now += s

    monkeypatch.setattr(serve, "time", types.SimpleNamespace(perf_counter=perf_counter,
                                                              sleep=sleep, time=perf_counter))
    init = NeoEngine.__init__

    def traced_init(self, *a, **k):
        init(self, *a, **k)
        clock.dt = steps["closed" if not made else "open"]
        made.append(self)
        loc = {}
        where.append(loc)
        step = self._step

        def located(now):
            emitted = step(now)
            for rid, _ in emitted:
                loc.setdefault(rid, []).append(self.requests[rid].location)
            return emitted

        self._step = located

    monkeypatch.setattr(NeoEngine, "__init__", traced_init)
    res = serve.run_sustained(arch=ARCH, smoke=True, device="cpu", n=16, rate=4.0,
                              device_pages=64, host_pages=256)
    closed, open_ = where
    moved = {rid: next(i for i, (a, b) in enumerate(zip(closed[rid], open_[rid])) if a != b)
             for rid in closed if closed[rid] != open_[rid]}
    assert moved == {6: 7, 7: 6, 8: 8, 12: 0, 15: 2}
    assert res["pass"] and res["open"]["planahead_hits"] > 0
    assert [e.stats.iterations for e in made] == [67, 76]
