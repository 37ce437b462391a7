"""The paged decode kernel on the card: held to its plain version over
shapes that take the page-split and single-range paths (hd = 112 and a
group of 7 included), a row's output bitwise the same in batches of 1, 8
and 64, and the engine's tokens through the kernel held to its tokens
through the plain version.  These tests carry the ``cuda`` marker and skip
without a card; the page-split arithmetic is checked everywhere."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
    HAS_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAS_HYPOTHESIS = False

from repro_torch.kernels.paged_decode import ops  # noqa: E402
from repro_torch.kernels.paged_decode.ref import paged_decode_ref  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, B, H, KV, hd, page, npages, lens):
    rng = np.random.default_rng(seed)
    P = npages * 4
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp = rng.normal(size=(P, page, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(P, page, KV, hd)).astype(np.float32)
    bt = rng.integers(0, P, size=(B, npages)).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _port(arrs, dtype, device):
    q, kp, vp, bt, lens = (torch.from_numpy(a).to(device) for a in arrs)
    dt = getattr(torch, dtype)
    return q.to(dt), kp.to(dt), vp.to(dt), bt, lens


def _live_blocks(n_pages, grid_z, pps):
    """The page ranges of the grid.z blocks of one row that do work (the
    kernel's rule: block z covers [z pps, min((z + 1) pps, n_pages)))."""
    return [(z * pps, min((z + 1) * pps, n_pages)) for z in range(grid_z)
            if z * pps < n_pages]


if HAS_HYPOTHESIS:
    @settings(max_examples=200, deadline=None)
    @given(st.lists(st.integers(0, 5000), min_size=1, max_size=64),
           st.sampled_from([1, 4, 8, 16, 32, ops.PAGES_PER_SPLIT]),
           st.sampled_from([8, 16, 32]))
    def test_page_split_covers_every_page_once(lens, pps, page):
        """Each row's ranges cover its pages once, in order, in runs of
        ``pps`` (the last shorter), and depend on the row's own page count
        only: the blocks of the batch's grid.z that do work for a row are
        the row's ranges alone, whatever batch it is in."""
        n_pages = [-(-n // page) for n in lens]
        grid_z = max(1, len(ops.split_pages(max(n_pages), pps)))
        for n in n_pages:
            ranges = ops.split_pages(n, pps)
            assert [p for a, b in ranges for p in range(a, b)] == list(range(n))
            assert all(b - a == pps for a, b in ranges[:-1])
            assert all(0 < b - a <= pps for a, b in ranges)
            assert _live_blocks(n, grid_z, pps) == ranges
            assert ranges == ops.split_pages(n, pps)  # alone: the same ranges
else:  # pragma: no cover
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_page_split_covers_every_page_once():
        pass


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lens", [
    ((3, 16, 8, 128, 16, 8), [0, 17, 128]),       # split over pages
    ((2, 14, 2, 112, 16, 4), [1, 64]),            # one range per row
    ((4, 4, 1, 32, 8, 4), [8, 9, 32, 3]),
    ((1, 16, 8, 128, 16, 130), [2070]),           # long row, many ranges
])
def test_cuda_kernel_matches_plain(shape, lens, cuda):
    arrs = _inputs(5, *shape, lens=lens)
    for dtype, tol in (("float32", 2e-3), ("bfloat16", 2e-2)):
        args = _port(arrs, dtype, device=cuda)
        before = ops.paged_decode_attention.launches
        merges = ops.paged_decode_attention.merge_launches
        got = ops.paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert ops.paged_decode_attention.launches == before + 1
        slots = len(ops.split_pages(shape[5]))  # grid.z: ranges of the widest table
        assert ops.paged_decode_attention.merge_launches == merges + (slots > 1)
        want = paged_decode_ref(*args)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        assert not got[torch.as_tensor(lens, device=cuda) == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_row_bitwise_invariant_across_batches(dtype, cuda):
    """A row's output is bitwise the same alone and at any place in batches
    of 8 and 64 whose other rows have other lengths and wider block tables
    (other grid.z, other merge launches): its ranges, and every sum its
    output is made of, depend on its own length only."""
    rng = np.random.default_rng(21)
    H, KV, hd, page, P = 16, 8, 128, 16, 4096
    dt = getattr(torch, dtype)
    kp = torch.from_numpy(rng.normal(size=(P, page, KV, hd)).astype(np.float32)).to(cuda, dt)
    vp = torch.from_numpy(rng.normal(size=(P, page, KV, hd)).astype(np.float32)).to(cuda, dt)
    q_row = rng.normal(size=(H, hd)).astype(np.float32)
    len_row = 1000  # 63 pages: several ranges, a ragged last page
    pages_row = rng.permutation(P)[:-(-len_row // page)]
    outs = []
    for B, where, width in ((1, 0, 63), (8, 5, 130), (64, 40, 200)):
        q = rng.normal(size=(B, H, hd)).astype(np.float32)
        q[where] = q_row
        lens = rng.integers(0, width * page + 1, size=B).astype(np.int32)
        lens[where] = len_row
        bt = rng.integers(0, P, size=(B, width)).astype(np.int32)
        bt[where, : len(pages_row)] = pages_row
        args = (torch.from_numpy(q).to(cuda, dt), kp, vp, torch.from_numpy(bt).to(cuda),
                torch.from_numpy(lens).to(cuda))
        out = ops.paged_decode_attention(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), paged_decode_ref(*args).float(),
                                   rtol=2e-2, atol=2e-2)
        outs.append(out[where].clone())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.cuda
def test_cuda_smem_formula_matches_kernel(cuda):
    """The wrapper's shared-memory formula (checked before a launch) is the
    kernel's own."""
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.load(ops.SOURCE).paged_decode_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    for hd, page, qpk in ((128, 16, 2), (112, 16, 7), (32, 8, 4), (256, 32, 1)):
        for code, dt in ((0, torch.float32), (1, torch.bfloat16)):
            assert fn(hd, page, qpk, code) == ops.smem_bytes(hd, page, qpk, dt)


@pytest.mark.cuda
def test_engine_tokens_through_kernel_equal_plain_version(cuda):
    """ROADMAP K1's engine gate: the same engine (fp32 smoke config, tight
    pools so rows offload and swap) emits the same greedy tokens on the card,
    where device rows go through the kernel, as on the CPU, where they go
    through the plain version."""
    from repro_torch.config import EngineConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.engine import NeoEngine

    cfg = get_smoke_config("qwen3-0.6b")
    ecfg = EngineConfig(device_pool_pages=7, host_pool_pages=96, max_batch_tokens=64,
                        policy="neo", pipeline=False, hw_profile="h100_sxm",
                        ewma_alpha=0.0)
    cpu = NeoEngine(cfg, ecfg, device="cpu")
    gpu = NeoEngine(cfg, ecfg, device=cuda, params=cpu.model.state_dict())
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, 500, size=n))) for n in (24, 30, 18, 22)]
    before = ops.paged_decode_attention.launches
    outs = []
    for eng in (cpu, gpu):
        rids = [eng.submit(p, 6) for p in prompts]
        done = eng.run_until_done(300)
        outs.append([done[r] for r in rids])
    assert outs[1] == outs[0]
    assert gpu.stats.offloaded_decodes > 0 and gpu.stats.device_decodes > 0
    assert ops.paged_decode_attention.launches > before
