"""The port's paged pools against the JAX package's: free list and refcount
semantics, page I/O, whole-request swaps with the same swap-byte accounting,
the host pool's dtype rule, and the zero-copy numpy view of the host pool."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.kv_cache import DualPool as RefDualPool  # noqa: E402
from repro.core.request import Request as RefRequest  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.kv_cache import DualPool  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402

ARCH = "qwen3-0.6b"
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype):
    kw = dict(param_dtype=dtype, activation_dtype=dtype)
    return ref_smoke(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)


def test_alloc_free_refcount():
    pool = DualPool(get_smoke_config(ARCH), 8, 4, device="cpu").device
    a = pool.alloc(3)
    assert a == [0, 1, 2] and pool.free_pages == 5 and pool.used_pages == 3
    seen = []
    pool.set_ref_listener(lambda p, old, new: seen.append((p, old, new)))
    pool.incref([1])
    assert pool.refcount(1) == 2
    pool.free(a)
    assert pool.free_pages == 7 and pool.refcount(1) == 1  # shared page survives
    pool.free([1])
    assert pool.free_pages == 8
    assert seen == [(1, 1, 2), (0, 1, 0), (1, 2, 1), (2, 1, 0), (1, 1, 0)]
    with pytest.raises(ValueError):
        pool.free([1])  # double free
    with pytest.raises(ValueError):
        pool.incref([1])  # incref of a free page
    with pytest.raises(ValueError):
        pool.free([3, 3])
    with pytest.raises(MemoryError):
        pool.alloc(9)


@pytest.mark.parametrize("dtype", DTYPES)
def test_put_read_round_trip(dtype):
    _, cfg = _cfgs(dtype)
    dp = DualPool(cfg, 6, 6, device="cpu")
    rng = np.random.default_rng(0)
    L, page, KV, hd = cfg.num_layers, cfg.kv_block_size, cfg.num_kv_heads, cfg.head_dim
    data = torch.from_numpy(rng.normal(size=(2, L, 2, page, KV, hd)).astype(np.float32))
    for pool in (dp.device, dp.host):
        pool.put_pages([4, 1], data[0], data[1])
        k, v = pool.read_pages([4, 1])
        assert k.dtype == pool.dtype and tuple(k.shape) == (L, 2, page, KV, hd)
        tol = 0 if pool.dtype == torch.float32 else 1e-2
        torch.testing.assert_close(k.float(), data[0], rtol=tol, atol=tol)
        torch.testing.assert_close(v.float(), data[1], rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_pool_dtype_rule(dtype):
    _, cfg = _cfgs(dtype)
    dp = DualPool(cfg, 2, 2, device="cpu")
    want_host = torch.float32 if dtype == "float32" else torch.float16
    assert dp.host.k.dtype == want_host and dp.device.k.dtype == getattr(torch, dtype)
    ref = RefDualPool(_cfgs(dtype)[0], 2, 2)
    assert dp.host.k.element_size() == ref.host.k.dtype.itemsize


def test_host_numpy_view_aliases_tensor():
    dp = DualPool(get_smoke_config(ARCH), 2, 3, device="cpu")
    view = dp.host.k.numpy()
    view[0, 2, 1, 0, 5] = 7.0
    assert float(dp.host.k[0, 2, 1, 0, 5]) == 7.0
    dp.host.put_pages([1], torch.ones_like(dp.host.k[:, :1]), torch.ones_like(dp.host.v[:, :1]))
    assert view[:, 1].min() == 1.0 and np.shares_memory(view, dp.host.k.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_swap_request_matches_reference(dtype):
    cfg_ref, cfg = _cfgs(dtype)
    ref = RefDualPool(cfg_ref, 8, 8)
    port = DualPool(cfg, 8, 8, device="cpu")
    rng = np.random.default_rng(1)
    L, page, KV, hd = cfg.num_layers, cfg.kv_block_size, cfg.num_kv_heads, cfg.head_dim
    k = rng.normal(size=(L, 3, page, KV, hd)).astype(np.float32)
    v = rng.normal(size=(L, 3, page, KV, hd)).astype(np.float32)
    reqs = []
    for pools, req_cls in ((ref, RefRequest), (port, Request)):
        r = req_cls(rid=0, prompt=[1] * 40, max_new_tokens=4)
        r.pages = pools.device.alloc(3)
        reqs.append(r)
    ref.device.put_pages(reqs[0].pages, k, v)
    port.device.put_pages(reqs[1].pages, torch.from_numpy(k), torch.from_numpy(v))

    for to in ("cpu", "gpu"):
        ref.swap_request(reqs[0], to)
        port.swap_request(reqs[1], to)
        assert reqs[1].location == reqs[0].location == to
        assert reqs[1].pages == reqs[0].pages
        assert port.swap_bytes == ref.swap_bytes > 0
        assert port.device.free_pages == ref.device.free_pages
        assert port.host.free_pages == ref.host.free_pages
        pool_r = ref.host if to == "cpu" else ref.device
        pool_p = port.host if to == "cpu" else port.device
        want_k, want_v = pool_r.read_pages(reqs[0].pages)
        got_k, got_v = pool_p.read_pages(reqs[1].pages)
        np.testing.assert_array_equal(got_k.float().numpy(), np.asarray(want_k, np.float32))
        np.testing.assert_array_equal(got_v.float().numpy(), np.asarray(want_v, np.float32))


def test_swap_of_empty_request_only_moves_location():
    port = DualPool(get_smoke_config(ARCH), 4, 4, device="cpu")
    r = Request(rid=0, prompt=[1], max_new_tokens=1)
    port.swap_request(r, "cpu")
    assert r.location == "cpu" and port.swap_bytes == 0
