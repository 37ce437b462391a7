"""The pipelined engine's CUDA paths on the card: the TransferEngine's
copy streams ordered against the compute stream, and the pipelined engine
(async swaps, host lanes on their own streams) emitting the serial engine's
tokens.  These tests carry the ``cuda`` marker and skip without a card; the
CPU paths are held to the JAX reference in ``test_torch_transfer.py`` and
``test_torch_pipeline.py``.  No JAX here: the card's machine has none."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.kv_cache import DualPool  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.core.transfer import TransferEngine  # noqa: E402

ARCH = "qwen3-0.6b"
CFG = get_smoke_config(ARCH)
WAIT = 60.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the copy streams and pinned staging are CUDA's)")
    return torch.device("cuda")


def _mk_request(rid, pool, n_pages):
    req = Request(rid=rid, prompt=[1, 2, 3], max_new_tokens=4)
    req.state = RequestState.RUNNING
    req.location = "gpu"
    req.pages = pool.device.alloc(n_pages)
    return req


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 500, size=n))) for n in lens]


def _run(eng, prompts, n_new, max_iters=400):
    rids = [eng.submit(p, n_new) for p in prompts]
    out = eng.run_until_done(max_iters)
    return [out[r] for r in rids]


@pytest.mark.cuda
def test_card_swaps_order_against_the_compute_stream(cuda):
    """On the card: a write queued on the compute stream after swap_out's
    launch (a new owner of the freed pages) does not reach the host copy,
    a write queued before it does, and a swap-in lands after its join."""
    cfg = CFG.replace(name="bf16-smoke", param_dtype="bfloat16", activation_dtype="bfloat16")
    pool = DualPool(cfg, 8, 8, device=cuda)
    compute = torch.cuda.Stream(cuda)
    te = TransferEngine(pool, compute_stream=compute)
    try:
        req = _mk_request(0, pool, 2)
        shape = (cfg.num_attention_layers, 2, cfg.kv_block_size, cfg.num_kv_heads, cfg.head_dim)
        with torch.cuda.stream(compute):
            before = torch.randn(shape, device=cuda)
            pool.device.put_pages(req.pages, before, before)  # queued, not yet synced
            h = te.swap_out(req)
            new_owner = pool.device.alloc(pool.device.free_pages)
            zeros = torch.zeros(shape[0], len(new_owner), *shape[2:], device=cuda)
            pool.device.put_pages(new_owner, zeros, zeros)
        te.join([h], timeout=WAIT)
        k_host, _ = pool.host.read_pages(req.pages)
        torch.testing.assert_close(k_host, before.to(torch.bfloat16).cpu().half(),
                                   rtol=0, atol=0)
        pool.device.free(new_owner)
        with torch.cuda.stream(compute):
            h2 = te.swap_in(req)
            te.join([h2], timeout=WAIT)
            k_dev, _ = pool.device.read_pages(req.pages)
        compute.synchronize()
        torch.testing.assert_close(k_dev.cpu(), k_host.to(torch.bfloat16), rtol=0, atol=0)
    finally:
        te.close()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["neo", "fastdecode"])
def test_card_pipelined_matches_serial(policy, cuda):
    """On the card (fp32, TF32 off): the pipelined engine, with async swaps
    on the copy streams and host lanes on their own streams, emits the
    serial engine's tokens under swap pressure."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(ARCH)
    prompts = _prompts(11, (24, 30, 18, 22, 26, 28))
    outs, stats = [], []
    for pipeline in (True, False):
        eng = NeoEngine(cfg, EngineConfig(device_pool_pages=7, host_pool_pages=128,
                                          max_batch_tokens=128, policy=policy,
                                          pipeline=pipeline, ewma_alpha=0.0), device=cuda)
        try:
            outs.append(_run(eng, prompts, 6))
            stats.append(eng.stats)
        finally:
            eng.close()
    assert outs[0] == outs[1]
    assert stats[0].pipelined_steps > 0 and stats[0].offloaded_decodes > 0
