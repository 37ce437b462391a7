"""The port's TransferEngine against the JAX package's: the cases of
``tests/test_transfer.py`` on the port's asynchronous swaps (round trip,
free accounting at launch, empty request, idempotent close, swap after
close, close after a failed transfer, per-direction concurrency, lane-scoped
joins, the f16 host pool), with the byte accounting held to the reference's
over the same swap sequence.  Every wait here has a timeout and every
TransferEngine is closed in teardown."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.kv_cache import DualPool as RefPool  # noqa: E402
from repro.core.request import Request as RefRequest  # noqa: E402
from repro.core.request import RequestState as RefState  # noqa: E402
from repro.core.transfer import TransferEngine as RefTransfer  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.kv_cache import DualPool  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.core.transfer import TransferEngine  # noqa: E402

CFG = get_smoke_config("qwen3-0.6b")
WAIT = 10.0


@pytest.fixture
def engines():
    """Factory of (pool, TransferEngine) pairs, all closed in teardown."""
    made = []

    def make(device_pages=8, host_pages=8, cfg=CFG, **kw):
        pool = DualPool(cfg, device_pages, host_pages, device="cpu")
        te = TransferEngine(pool, **kw)
        made.append(te)
        return pool, te

    yield make
    for te in made:
        try:
            te.close()
        except Exception:
            pass


def _mk_request(rid, pool, n_pages, location="gpu", req_cls=Request, state=RequestState):
    req = req_cls(rid=rid, prompt=[1, 2, 3], max_new_tokens=4)
    req.state = state.RUNNING
    req.location = location
    req.pages = (pool.device if location == "gpu" else pool.host).alloc(n_pages)
    return req


def _fill(cfg, pool, req, seed=0, location="gpu"):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_attention_layers, len(req.pages), cfg.kv_block_size,
             cfg.num_kv_heads, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    (pool.device if location == "gpu" else pool.host).put_pages(
        req.pages, torch.from_numpy(k), torch.from_numpy(v))
    return k, v


def test_roundtrip_preserves_kv(engines):
    pool, te = engines()
    req = _mk_request(0, pool, 3)
    k, v = _fill(CFG, pool, req)
    te.join([te.swap_out(req)])
    assert req.location == "cpu"
    k_host, v_host = pool.host.read_pages(req.pages)
    np.testing.assert_array_equal(k_host.numpy(), k)
    np.testing.assert_array_equal(v_host.numpy(), v)
    assert te.stats.bytes_out == k_host.nbytes + v_host.nbytes
    assert pool.swap_bytes == te.stats.bytes_out
    te.join([te.swap_in(req)])
    assert req.location == "gpu"
    k_dev, v_dev = pool.device.read_pages(req.pages)
    np.testing.assert_array_equal(k_dev.numpy(), k)
    np.testing.assert_array_equal(v_dev.numpy(), v)
    assert te.stats.bytes_in > 0
    assert pool.device.free_pages == 8 - 3 and pool.host.free_pages == 8


def test_free_accounting_at_launch(engines):
    """Page accounting moves at LAUNCH (the scheduler plans against it),
    while the copy may still be in flight."""
    pool, te = engines(6, 6)
    req = _mk_request(0, pool, 4)
    h = te.swap_out(req)
    assert pool.device.free_pages == 6 and pool.host.free_pages == 2
    assert req.location == "cpu"
    te.join([h])
    te.drain()


def test_freed_device_pages_keep_the_launch_snapshot(engines):
    """The reference snapshots device pages at submit; the port's in-place
    pool must give the same: a write to a page freed at launch (a new
    owner's prefill) does not reach the swapped-out copy."""
    pool, te = engines()
    req = _mk_request(0, pool, 2)
    k, v = _fill(CFG, pool, req)
    freed = list(req.pages)
    h = te.swap_out(req)
    new_owner = pool.device.alloc(pool.device.free_pages)
    assert set(freed) <= set(new_owner)
    zeros = torch.zeros(k.shape[0], len(new_owner), *k.shape[2:])
    pool.device.put_pages(new_owner, zeros, zeros)
    te.join([h])
    np.testing.assert_array_equal(pool.host.read_pages(req.pages)[0].numpy(), k)


def test_empty_request(engines):
    pool, te = engines(2, 2)
    req = Request(rid=0, prompt=[1], max_new_tokens=1)
    h = te.swap_out(req)
    assert h.done() and req.location == "cpu"
    h2 = te.swap_in(req)
    assert h2.done() and req.location == "gpu"


def test_close_is_idempotent_and_joins_workers(engines):
    pool, te = engines()
    req = _mk_request(0, pool, 2)
    _fill(CFG, pool, req)
    h = te.swap_out(req)
    te.close()
    assert h.done() and h.error is None  # draining close: the swap completed
    assert not any(w.is_alive() for w in te._workers.values())
    te.close()
    assert te._closed


def test_swap_after_close_raises(engines):
    pool, te = engines()
    te.close()
    req = _mk_request(1, pool, 1)
    with pytest.raises(RuntimeError, match="closed"):
        te.swap_out(req)
    with pytest.raises(RuntimeError, match="closed"):
        te.swap_in(req)


def test_close_survives_failed_transfer(engines):
    """A job that failed in flight must not wedge close(): the error is
    re-raised only after every queue drained and every worker joined."""
    pool, te = engines()
    req = _mk_request(0, pool, 2)
    _fill(CFG, pool, req)
    te.join([te.swap_out(req)])
    bad = te.swap_in(req)
    assert bad.wait(WAIT)  # let the gather finish before poisoning
    bad.error = RuntimeError("injected copy failure")
    with pytest.raises(RuntimeError, match="injected copy failure"):
        te.close()
    assert te._closed
    assert not any(w.is_alive() for w in te._workers.values())


def test_per_direction_streams_concurrent_in_out(engines):
    """A stalled device->host copy must not block a concurrent host->device
    swap-in on its own stream."""
    pool, te = engines()
    req_out = _mk_request(0, pool, 3)
    req_in = _mk_request(1, pool, 1, location="cpu")
    k_out, _ = _fill(CFG, pool, req_out, seed=0)
    k_in, _ = _fill(CFG, pool, req_in, seed=1, location="cpu")
    release = threading.Event()
    out_nbytes = 2 * k_out.nbytes
    orig = pool.add_swap_bytes

    def stalled(n):
        if n == out_nbytes:
            release.wait(timeout=WAIT)
        orig(n)

    pool.add_swap_bytes = stalled
    h_out = te.swap_out(req_out)  # queued first
    h_in = te.swap_in(req_in)
    te.join([h_in], timeout=WAIT)  # completes although the out stream is stalled
    assert not h_out.done()
    release.set()
    te.join([h_out, h_in], timeout=WAIT)
    np.testing.assert_array_equal(pool.device.read_pages(req_in.pages)[0].numpy(), k_in)
    np.testing.assert_array_equal(pool.host.read_pages(req_out.pages)[0].numpy(), k_out)
    assert set(te.stats.busy_by_stream) == {"out", "in"}


def test_lane_scoped_join_requests(engines):
    """join_requests joins exactly the given requests' pending transfers
    (the per-lane join point) and leaves the rest for drain()."""
    pool, te = engines()
    ra, rb = _mk_request(0, pool, 2), _mk_request(1, pool, 2)
    _fill(CFG, pool, ra, 0)
    _fill(CFG, pool, rb, 1)
    ha = te.swap_out(ra)
    hb = te.swap_out(rb)
    te.join_requests([ra], kind="out")
    assert ha.done()
    with te._lock:
        pending = list(te._pending)
    assert ha not in pending
    assert hb in pending or hb.done()
    te.join_requests([rb], kind="in")  # a kind mismatch joins nothing
    with te._lock:
        assert hb in te._pending
    te.drain()
    with te._lock:
        assert not te._pending


def _ref_sequence():
    cfg = ref_smoke("qwen3-0.6b")
    pool = RefPool(cfg, device_pages=8, host_pages=8)
    te = RefTransfer(pool, per_direction=True)
    try:
        r0 = _mk_request(0, pool, 3, req_cls=RefRequest, state=RefState)
        te.join([te.swap_out(r0)])
        te.join([te.swap_in(r0)])
        r1 = _mk_request(1, pool, 1, req_cls=RefRequest, state=RefState)
        te.join([te.swap_out(r1)])
        return (te.stats.bytes_out, te.stats.bytes_in, te.stats.jobs, pool.swap_bytes,
                pool.device.free_pages, pool.host.free_pages)
    finally:
        te.close()


def test_byte_accounting_matches_reference(engines):
    """The same swap sequence moves the same bytes, in the same number of
    jobs, as the reference's per-direction TransferEngine."""
    pool, te = engines()
    r0 = _mk_request(0, pool, 3)
    _fill(CFG, pool, r0, seed=3)
    te.join([te.swap_out(r0)])
    te.join([te.swap_in(r0)])
    r1 = _mk_request(1, pool, 1)
    _fill(CFG, pool, r1, seed=4)
    te.join([te.swap_out(r1)])
    got = (te.stats.bytes_out, te.stats.bytes_in, te.stats.jobs, pool.swap_bytes,
           pool.device.free_pages, pool.host.free_pages)
    assert got == _ref_sequence()


def test_swap_in_frees_host_pages_at_join(engines):
    """A swap-in takes its device pages at launch and gives its host pages
    back only when it is joined (the device write happens there)."""
    pool, te = engines(6, 6)
    req = _mk_request(0, pool, 2)
    k, _ = _fill(CFG, pool, req, seed=5)
    te.join([te.swap_out(req)])
    h = te.swap_in(req)
    assert pool.device.free_pages == 4 and pool.host.free_pages == 4
    assert req.location == "gpu"
    te.join([h])
    assert pool.host.free_pages == 6
    np.testing.assert_array_equal(pool.device.read_pages(req.pages)[0].numpy(), k)


def test_host_gather_is_a_snapshot_of_whole_pages(engines):
    """PagePool.gather (what a swap-in reads) returns every layer of the
    given pages in the pool's dtype, or the one asked for, and later writes
    to those pages do not reach it."""
    pool, _ = engines()
    req = _mk_request(0, pool, 3, location="cpu")
    k, v = _fill(CFG, pool, req, seed=6, location="cpu")
    pages = req.pages[::-1]
    gk, gv = pool.host.gather(pages)
    g16, _ = pool.host.gather(pages, torch.float16)
    order = [req.pages.index(p) for p in pages]
    np.testing.assert_array_equal(gk.numpy(), k[:, order])
    np.testing.assert_array_equal(gv.numpy(), v[:, order])
    assert g16.dtype == torch.float16
    np.testing.assert_array_equal(g16.numpy(), k[:, order].astype(np.float16))
    zeros = torch.zeros(k.shape[0], len(pages), *k.shape[2:])
    pool.host.put_pages(req.pages, zeros, zeros)
    np.testing.assert_array_equal(gk.numpy(), k[:, order])
    np.testing.assert_array_equal(g16.numpy(), k[:, order].astype(np.float16))


def test_f16_host_pool_roundtrip(engines):
    """16-bit archs keep the host pool in float16: bf16 device -> f16 host
    is exact for these values, and the bytes are counted at 2 per element."""
    cfg = CFG.replace(name="bf16-smoke", param_dtype="bfloat16",
                      activation_dtype="bfloat16")
    pool, te = engines(6, 6, cfg=cfg)
    assert pool.host.k.dtype == torch.float16 and pool.device.k.dtype == torch.bfloat16
    req = _mk_request(0, pool, 2)
    k, _ = _fill(cfg, pool, req, seed=2)
    te.join([te.swap_out(req)])
    k_host, _ = pool.host.read_pages(req.pages)
    np.testing.assert_allclose(k_host.float().numpy(), k, atol=1e-2)
    assert te.stats.bytes_out == 2 * k_host.numel() * 2
    te.join([te.swap_in(req)])
    k_dev, _ = pool.device.read_pages(req.pages)
    torch.testing.assert_close(k_dev, k_host.to(torch.bfloat16), rtol=0, atol=0)


def test_join_times_out_instead_of_hanging(engines):
    pool, te = engines()
    req = _mk_request(0, pool, 1)
    release = threading.Event()
    orig = pool.add_swap_bytes
    pool.add_swap_bytes = lambda n: (release.wait(WAIT), orig(n))
    h = te.swap_out(req)
    with pytest.raises(TimeoutError):
        te.join([h], timeout=0.2)
    release.set()
    assert h.wait(WAIT)
