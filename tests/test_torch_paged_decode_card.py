"""The paged decode kernel on the card: held to its plain version over
shapes that take the page-split and single-range paths (hd = 112 and a
group of 7 included), and the engine's tokens through the kernel held to
its tokens through the plain version.  These tests carry the ``cuda``
marker and skip without a card; the page-split arithmetic is checked
everywhere."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def test_page_split_covers_every_page_once():
    for rows_x_kv, max_pages in ((64, 50), (512, 128), (8, 129), (64, 4), (1, 1),
                                 (2048, 128), (24, 3), (1, 300)):
        n = ops.split_pages(rows_x_kv, max_pages, sm_count=132)
        per = -(-max_pages // n)
        assert 1 <= n <= max_pages
        assert per * n >= max_pages > per * (n - 1)  # no empty trailing range
        assert per >= min(ops.MIN_PAGES_PER_SPLIT, max_pages)
        if rows_x_kv >= ops.BLOCKS_PER_SM * 132:
            assert n == 1  # enough blocks already


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
        split = ops.split_pages(shape[0] * shape[2], shape[5], ops._sm_count(cuda.index or 0))
        assert ops.paged_decode_attention.merge_launches == merges + (split > 1)
        want = paged_decode_ref(*args)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        assert not got[torch.as_tensor(lens, device=cuda) == 0].any()


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
