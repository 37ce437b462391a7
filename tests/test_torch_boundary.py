"""The port's boundaries: it imports nothing of JAX or of the JAX package,
its entry points run on the card unless asked for the CPU, and engine
options it has not ported raise instead of running something else."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.kv_cache import DualPool  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.transformer import DenseLM  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
CFG = get_smoke_config("qwen3-0.6b")

_IMPORT_CHECK = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
for n in ("repro_torch.core.transfer", "repro_torch.core.prefix_cache",
          "repro_torch.core.spec", "repro_torch.serving.simulator",
          "repro_torch.models.moe", "repro_torch.models.encdec",
          "repro_torch.kernels.flash_prefill.ops",
          "repro_torch.kernels.flash_prefill.ref", "repro_torch.obs",
          "repro_torch.obs.tracer", "repro_torch.obs.reconcile", "repro_torch.obs.validate"):
    assert n in names, n
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20  # every module was imported


def test_no_reference_import_statements():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|"
                     r"import repro\s*$|from repro import)", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_cpu_fallback(no_cuda):
    ecfg = EngineConfig(pipeline=False, device_pool_pages=4, host_pool_pages=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        NeoEngine(CFG, ecfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        DenseLM(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        DualPool(CFG, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        NeoEngine(CFG, ecfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--no-pipeline", "--n", "1"])
    # the pipelined engine and the default CLI (pipelined, closed loop) too
    with pytest.raises(RuntimeError, match="CUDA"):
        NeoEngine(CFG, EngineConfig(pipeline=True, device_pool_pages=4, host_pool_pages=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--n", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--n", "1", "--arrivals", "poisson"])


@pytest.mark.parametrize("arch,option,exc,match", [
    ("internvl2-1b", dict(pipeline=False, tp=2), NotImplementedError, "dense family only"),
    ("deepseek-moe-16b", dict(pipeline=False, tp=2), NotImplementedError, "dense family only"),
    ("rwkv6-7b", dict(tp=2), ValueError, "requires the paged engine"),
])
def test_unported_engine_options_raise(arch, option, exc, match):
    """What the reference's engine refuses, the port's refuses with its
    exception and message: tensor parallelism beyond the dense family (vlm,
    moe) and on a contiguous family (every family is ported:
    test_every_family_builds_on_cpu; speculative decoding and dense
    tensor parallelism, refused here until they were ported, build:
    test_spec_decode_engine_builds_on_cpu, tests/test_torch_tp.py)."""
    with pytest.raises(exc, match=match):
        NeoEngine(get_smoke_config(arch), EngineConfig(**option), device="cpu")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "internvl2-1b", "seamless-m4t-medium"])
def test_every_family_builds_on_cpu(arch):
    """The moe, vlm and audio families (refused until they were ported)
    build their engine (paged for moe and vlm, contiguous for audio) and
    serve a request; nothing in the port names a family as unported."""
    cfg = get_smoke_config(arch)
    eng = NeoEngine(cfg, EngineConfig(device_pool_pages=8, host_pool_pages=16,
                                      max_batch_tokens=64), device="cpu")
    try:
        assert eng.paged == (cfg.family != "audio")
        extras = ({"frames": np.zeros((4, cfg.d_model), np.float32)}
                  if cfg.family == "audio" else None)
        rid = eng.submit([1, 2, 3, 4, 5], 2, extras=extras)
        assert len(eng.run_until_done(50)[rid]) == 2
    finally:
        eng.close()
    src = "\n".join(f.read_text() for f in PORT.rglob("*.py"))
    assert "ROADMAP P11" not in src and "ROADMAP P12" not in src


def test_spec_decode_engine_builds_on_cpu():
    """``spec_decode=True`` builds the paged engine with the n-gram drafter
    of order ``spec_ngram`` and serves a repetitive prompt with verify
    passes; the contiguous engine gets no drafter (the reference's rule)."""
    from repro_torch.core.spec import NgramDrafter

    eng = NeoEngine(CFG, EngineConfig(spec_decode=True, spec_ngram=2, device_pool_pages=16,
                                      host_pool_pages=16, max_batch_tokens=64), device="cpu")
    try:
        assert isinstance(eng.drafter, NgramDrafter) and eng.drafter.n == 2
        rid = eng.submit([5, 6, 7, 8] * 4, 6)
        assert len(eng.run_until_done(50)[rid]) == 6
        assert eng.stats.spec_steps > 0 and eng.stats.drafted_tokens > 0
    finally:
        eng.close()
    ssm = NeoEngine(get_smoke_config("rwkv6-7b"),
                    EngineConfig(spec_decode=True, pipeline=False, max_batch_tokens=64),
                    device="cpu")
    assert ssm.drafter is None and not ssm.paged
    ssm.close()


def test_prefix_cache_engine_builds_on_cpu():
    """``prefix_cache=True`` (refused before the cache was ported) builds the
    radix tree over the engine's pools and transfer engine, wires the tracer
    into it, and serves a repeated prompt from it."""
    eng = NeoEngine(CFG, EngineConfig(prefix_cache=True, tracing=True, device_pool_pages=16,
                                      host_pool_pages=16, max_batch_tokens=64), device="cpu")
    try:
        cache = eng.prefix_cache
        assert cache is not None and cache.pool is eng.pool and cache.transfer is eng.transfer
        assert cache.tracer is eng.tracer
        prompt = list(range(1, 2 * CFG.kv_block_size + 3))
        for _ in range(2):
            eng.submit(prompt, 2)
            eng.run_until_done(50)
        assert cache.stats.hits == 1 and cache.stats.hit_tokens == len(prompt) - 1
    finally:
        eng.close()


def test_tracing_engine_builds_on_cpu():
    """``tracing=True`` (refused before the tracer was ported) wires one
    tracer through the scheduler, the executor and the transfer engine."""
    eng = NeoEngine(CFG, EngineConfig(tracing=True), device="cpu")
    try:
        assert eng.tracer is not None and eng.tracer.capacity == EngineConfig.trace_buffer
        assert eng.scheduler.tracer is eng.executor.tracer is eng.transfer.tracer is eng.tracer
        eng.attach_tracer(None)
        assert eng.scheduler.tracer is eng.executor.tracer is eng.transfer.tracer is None
    finally:
        eng.close()


def test_pipelined_engine_runs_on_cpu_when_asked():
    """``pipeline=True`` (refused before the pipelined engine was ported)
    builds the TransferEngine and the host lanes and serves."""
    eng = NeoEngine(CFG, EngineConfig(pipeline=True, device_pool_pages=8, host_pool_pages=16,
                                      max_batch_tokens=64), device="cpu")
    try:
        assert eng.transfer is not None and eng.executor.host_lanes == 4
        rid = eng.submit([1, 2, 3, 4, 5], 3)
        assert len(eng.run_until_done(50)[rid]) == 3
    finally:
        eng.close()


def test_default_engine_config_is_pipelined_and_h100():
    ecfg = EngineConfig()
    assert ecfg.pipeline and ecfg.hw_profile == "h100_sxm"
    eng = NeoEngine(CFG, ecfg, device="cpu")
    try:
        assert eng.engine_cfg.pipeline and eng.transfer is not None
    finally:
        eng.close()


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    runs = [subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], env=env,
                           capture_output=True, text=True, timeout=300)]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    runs.append(subprocess.run([sys.executable, str(alone)], env=env, cwd=tmp_path,
                               capture_output=True, text=True, timeout=300))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
