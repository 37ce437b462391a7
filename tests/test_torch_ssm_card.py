"""The RWKV6 and Mamba2 scan kernels on the card: each held to its plain
version in both dtypes (ragged T, T = 1, T = 15, T = 4096, B = 3, a
partial head group, P != N, widths off the 16-byte copy path, a strong decay,
RWKV6 decays below FLT_MIN and the full-width shapes included), bitwise
equal over two calls, its launch and stage counters, and the contiguous engine's tokens through the
kernels held to its tokens through the plain versions.  These tests carry the ``cuda``
marker and skip without a card; the concurrent build is checked everywhere
with a stand-in compiler."""

import os
import stat
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 2e-2}  # tests/test_kernels.py tolerances


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def test_build_all_runs_one_compiler_per_source_concurrently(tmp_path, monkeypatch):
    """Every nvcc starts before any is joined: each stand-in compiler writes
    its start time, sleeps, then its end time and the library."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "out=''; prev=''\n"
                    "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
                    "python3 -c 'import time; print(time.time())' > \"$out.start\"\n"
                    "sleep 1\n"
                    "python3 -c 'import time; print(time.time())' > \"$out.end\"\n"
                    "touch \"$out\"\necho 'ptxas info : Used 1 registers'\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    sources = [rwkv_ops.SOURCE, ssd_ops.SOURCE]
    t0 = time.time()
    logs = _build.build_all(sources)
    assert all("registers" in logs[s] for s in sources)
    assert all(_build.library_path(s).exists() for s in sources)
    built = sorted((tmp_path / "build").iterdir())
    starts = [float(p.read_text()) for p in built if p.name.endswith(".start")]
    ends = [float(p.read_text()) for p in built if p.name.endswith(".end")]
    assert len(starts) == len(ends) == 2 and max(starts) < min(ends) and t0 <= min(starts)
    assert _build.build_all(sources) == {s: "" for s in sources}  # built already
    os.remove(_build.library_path(ssd_ops.SOURCE))
    fake.write_text("#!/bin/sh\necho 'error: no'\nexit 1\n")
    with pytest.raises(RuntimeError, match="nvcc failed for mamba2_ssd.cu"):
        _build.build_all(sources)


def _rwkv6(seed, B, T, H, N, dtype, device, strong=False, tiny_every=0):
    """``tiny_every`` sets w = 1e-40, below FLT_MIN, on every such token (as
    ``tests/test_torch_ssm_stages.py`` does)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, N)).astype(np.float32) for _ in range(3))
    z = rng.normal(size=(B, T, H, N))
    w = np.exp(-np.exp(np.log(5.0) + 0.1 * z if strong else z)).astype(np.float32)
    if tiny_every:
        w[:, ::tiny_every] = 1e-40
    u = rng.normal(size=(H, N)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
    rkv = [torch.from_numpy(a).to(device, dtype) for a in (r, k, v)]
    return (*rkv, *(torch.from_numpy(a).to(device) for a in (w, u, s0)))


def _mamba2(seed, B, T, H, P, N, dtype, device, strong=False):
    rng = np.random.default_rng(seed)
    lo, hi, alo, ahi = (1.0, 3.0, 1.0, 3.0) if strong else (0.001, 0.1, 0.5, 2.0)
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dt = rng.uniform(lo, hi, size=(B, T, H)).astype(np.float32)
    A = -rng.uniform(alo, ahi, size=(H,)).astype(np.float32)
    Bm, C = (rng.normal(size=(B, T, N)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(H,)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, P)) * 0.1).astype(np.float32)
    t = lambda a, dt_=torch.float32: torch.from_numpy(a).to(device, dt_)  # noqa: E731
    return t(x, dtype), t(dt), t(A), t(Bm, dtype), t(C, dtype), t(D), t(s0)


def _hold(kern, plain, args, dtype_name):
    counter = kern.launches
    got = kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == counter + 1
    want = plain(*args)
    tol = TOL[dtype_name]
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,strong", [
    ((2, 64, 4, 32), False),     # tests/test_kernels.py:100
    ((1, 100, 2, 16), False),    # ragged T
    ((2, 40, 3, 64), True),      # strong decay: pair decays at the clip
    ((1, 300, 8, 128), False),   # the largest head the kernel takes
    ((1, 1, 4, 64), False),      # one token
    ((1, 15, 4, 64), False),     # one partial chunk
    ((1, 4096, 4, 64), False),   # 64 state chunks
    ((3, 100, 113, 32), False),  # three rows, many heads
    ((2, 70, 2, 20), False),     # N off the 16-byte copy path in bf16
    ((1, 512, 64, 64), False),   # rwkv6-7b at full width
])
def test_rwkv6_kernel_matches_plain(shape, strong, dtype, cuda):
    args = _rwkv6(31, *shape, getattr(torch, dtype), cuda, strong)
    _hold(rwkv_ops.rwkv6_scan, lambda *a: rwkv6_chunked(*a, chunk=rwkv_ops.CHUNK), args, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 70, 3, 32),     # ragged T, a 16-token sub-chunk boundary on a tiny decay
    (1, 512, 64, 64),   # rwkv6-7b at full width
])
def test_rwkv6_kernel_matches_plain_below_flt_min(shape, dtype, cuda):
    """w = 1e-40 on every 7th token: the decays built from 16-token sub-chunk
    sums of log w (floored at the subnormal 1e-38, log -87.5; the build has no
    -ftz) stay within the card's tolerance of the plain version."""
    args = _rwkv6(37, *shape, getattr(torch, dtype), cuda, tiny_every=7)
    assert float(args[3].min()) == pytest.approx(1e-40, rel=1e-2)
    _hold(rwkv_ops.rwkv6_scan, lambda *a: rwkv6_chunked(*a, chunk=rwkv_ops.CHUNK), args, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,strong", [
    ((2, 64, 2, 32, 32), False),    # tests/test_kernels.py:137
    ((1, 100, 3, 32, 16), False),   # ragged T, P != N (the smoke shape)
    ((2, 130, 4, 24, 40), True),    # strong decay, P a partial tile
    ((1, 200, 4, 64, 128), False),  # the largest state the kernel takes
    ((1, 1, 4, 64, 64), False),     # one token
    ((1, 15, 4, 64, 64), False),    # one partial chunk
    ((1, 4096, 8, 64, 64), False),  # 64 chunks
    ((3, 100, 113, 64, 64), False),  # three rows, a partial group of heads
    ((1, 70, 3, 130, 20), False),   # P over one tile and off the 16-byte copy path
    ((1, 512, 112, 64, 64), False),  # zamba2-7b at full width
])
def test_mamba2_kernel_matches_plain(shape, strong, dtype, cuda):
    args = _mamba2(32, *shape, getattr(torch, dtype), cuda, strong)
    _hold(ssd_ops.mamba2_ssd, lambda *a: mamba2_ssd_chunked(*a, chunk=ssd_ops.CHUNK), args,
          dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,make,shape", [
    (rwkv_ops.rwkv6_scan, _rwkv6, (1, 512, 64, 64)),
    (ssd_ops.mamba2_ssd, _mamba2, (1, 512, 112, 64, 64))])
def test_kernel_is_deterministic(kernel, make, shape, dtype, cuda):
    """No atomics and a fixed summation order: two calls on the same inputs
    give bitwise equal outputs and states."""
    args = make(35, *shape, getattr(torch, dtype), cuda)
    y1, s1 = kernel(*args)
    y2, s2 = kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,make,shape", [
    (rwkv_ops.rwkv6_scan, _rwkv6, (2, 'T', 3, 32)),
    (ssd_ops.mamba2_ssd, _mamba2, (2, 'T', 3, 32, 16))])
def test_kernel_counts_calls_and_stages(kernel, make, shape, cuda):
    """``launches`` counts calls that launched, ``stage_launches`` the stages:
    three per call, one (the state pass alone) when T = 0, whose final
    state is the initial one."""
    for T, stages in ((100, 3), (0, 1)):
        args = make(36, *(T if d == 'T' else d for d in shape), torch.float32, cuda)
        calls, launched = kernel.launches, kernel.stage_launches
        y, sT = kernel(*args)
        torch.cuda.synchronize()
        assert kernel.launches == calls + 1 and kernel.stage_launches == launched + stages
        if T == 0:
            assert y.numel() == 0 and torch.equal(sT, args[-1])


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    with pytest.raises(ValueError, match="head size"):
        rwkv_ops.rwkv6_scan(*_rwkv6(33, 1, 16, 1, 160, torch.float32, cuda))
    with pytest.raises(ValueError, match="state size"):
        ssd_ops.mamba2_ssd(*_mamba2(33, 1, 16, 1, 16, 160, torch.float32, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernel", [("rwkv6-7b", rwkv_ops.rwkv6_scan),
                                         ("zamba2-7b", ssd_ops.mamba2_ssd)])
def test_engine_tokens_through_kernel_equal_plain_version(arch, kernel, cuda):
    """The same contiguous engine (fp32 smoke config, prefills staggered
    beside decoding rows) emits the same greedy tokens on the card, where
    every prefill runs the scan kernel, as on the CPU, where it runs the
    plain version."""
    from repro_torch.config import EngineConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import NeoEngine

    cfg = get_smoke_config(arch)
    ecfg = EngineConfig(max_batch_tokens=48, policy="neo", pipeline=False,
                        hw_profile="h100_sxm", ewma_alpha=0.0)
    cpu = NeoEngine(cfg, ecfg, device="cpu")
    gpu = NeoEngine(cfg, ecfg, device=cuda, params=cpu.model.state_dict())
    rng = np.random.default_rng(34)
    prompts = [list(map(int, rng.integers(1, 500, size=n))) for n in (40, 33, 21, 45)]
    before = kernel.launches
    outs = []
    for eng in (cpu, gpu):
        rids = [eng.submit(p, 6) for p in prompts]
        done = eng.run_until_done(300)
        outs.append([done[r] for r in rids])
    assert outs[1] == outs[0]
    assert kernel.launches - before == cfg.num_layers * len(prompts)
