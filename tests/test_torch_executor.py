"""The port's PagedExecutor against the JAX package's on identical pools and
page tables: cold prefill into both pools, then decode steps over a batch
that mixes device rows (paged decode kernel's plain version here) and host
rows (host attention over the host pool).  Logits and the pools after each
step must agree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.executor import PagedExecutor as RefExecutor  # noqa: E402
from repro.core.host_attention import HostAttention as RefHostAttention  # noqa: E402
from repro.core.kv_cache import DualPool as RefDualPool  # noqa: E402
from repro.core.request import Request as RefRequest  # noqa: E402
from repro.core.request import RequestState as RefState  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.executor import PagedExecutor  # noqa: E402
from repro_torch.core.host_attention import HostAttention  # noqa: E402
from repro_torch.core.kv_cache import DualPool  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.bridge import load_reference_params  # noqa: E402

ARCH = "qwen3-0.6b"
TOL = dict(rtol=1e-4, atol=1e-4)
PAGES = 24


@pytest.fixture(scope="module")
def executors():
    cfg_ref, cfg = ref_smoke(ARCH), get_smoke_config(ARCH)
    ref_model = ref_get_model(cfg_ref)
    params = ref_model.init(jax.random.key(3))
    model = load_reference_params(get_model(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, params))

    ref_pool = RefDualPool(cfg_ref, PAGES, PAGES)
    pool = DualPool(cfg, PAGES, PAGES, device="cpu")
    # identical random pool contents (pages the test never writes stay
    # distinguishable garbage on both sides)
    rng = np.random.default_rng(0)
    shape = tuple(pool.device.k.shape)
    for name in ("k", "v"):
        dev = rng.normal(size=shape).astype(np.float32)
        host = rng.normal(size=shape).astype(np.float32)
        setattr(ref_pool.device, name, jnp.asarray(dev))
        getattr(ref_pool.host, name)[...] = host
        getattr(pool.device, name).copy_(torch.from_numpy(dev))
        getattr(pool.host, name).copy_(torch.from_numpy(host))
    ref = RefExecutor(ref_model, params, ref_pool,
                      RefHostAttention(cfg_ref, ref_pool.host.k, ref_pool.host.v))
    port = PagedExecutor(model, pool, HostAttention(cfg, pool.host.k.numpy(),
                                                    pool.host.v.numpy()))
    return ref, port


def _requests(cls, specs):
    out = []
    for rid, (prompt, pages) in enumerate(specs):
        r = cls(rid=rid, prompt=list(prompt), max_new_tokens=8)
        r.pages = list(pages)
        out.append(r)
    return out


def _assert_pools_equal(ref, port, reqs, flags):
    """Pools agree on every token slot a request holds and on every page no
    request owns.  Slots of a request's last page past its written tokens
    are padding that neither side ever reads: the reference fills them with
    the K/V of its padded prefill bucket, the port with zeros."""
    valid = {"device": np.ones(PAGES * port.page, bool),
             "host": np.ones(PAGES * port.page, bool)}
    for r, host in zip(reqs, flags):
        side = "host" if host else "device"
        for p in r.pages:
            valid[side][p * port.page:(p + 1) * port.page] = False
        n = r.kv_len + (1 if r.out_tokens else 0)  # tokens written so far
        for pos in range(n):
            valid[side][r.pages[pos // port.page] * port.page + pos % port.page] = True
    for side in ("device", "host"):
        for name in ("k", "v"):
            want = np.asarray(getattr(getattr(ref.pool, side), name), np.float32)
            got = getattr(getattr(port.pool, side), name).numpy()
            sel = valid[side].reshape(PAGES, port.page)
            np.testing.assert_allclose(got[:, sel], want[:, sel],
                                       err_msg=f"{side}.{name}", **TOL)


def test_prefill_then_mixed_decode_matches_reference(executors):
    ref, port = executors
    rng = np.random.default_rng(1)
    # (prompt, pages, host?): pages cover the prompt plus two decode tokens
    specs = [
        (rng.integers(1, 500, size=13), [3, 4], False),
        (rng.integers(1, 500, size=30), [5, 6], True),
        (rng.integers(1, 500, size=16), [7, 8], False),
        (rng.integers(1, 500, size=5), [9], True),
        (rng.integers(1, 500, size=31), [10, 11, 14], False),
    ]
    flags = [h for _, _, h in specs]
    reqs = {}
    for name, cls in (("ref", RefRequest), ("port", Request)):
        reqs[name] = _requests(cls, [(p, pg) for p, pg, _ in specs])
    r_logits = ref.prefill(reqs["ref"], flags)
    p_logits = port.prefill(reqs["port"], flags)
    np.testing.assert_allclose(p_logits, np.asarray(r_logits), **TOL)
    _assert_pools_equal(ref, port, reqs["port"], flags)

    # two decode steps over the mixed batch, feeding the reference's tokens
    for _ in range(2):
        toks = np.asarray(r_logits).argmax(-1)
        for (name, state), rs in zip((("ref", RefState), ("port", RequestState)),
                                     (reqs["ref"], reqs["port"])):
            for r, t in zip(rs, toks):
                r.state = state.RUNNING
                r.out_tokens.append(int(t))
        r_logits = ref.decode(reqs["ref"], flags)
        p_logits = port.decode(reqs["port"], flags)
        assert p_logits.shape == np.asarray(r_logits).shape
        np.testing.assert_allclose(p_logits, np.asarray(r_logits), **TOL)
        _assert_pools_equal(ref, port, reqs["port"], flags)


def test_decode_rows_independent_of_batch(executors):
    """A device row's logits do not depend on which rows share its batch
    (all-host and all-device batches included)."""
    _, port = executors
    rng = np.random.default_rng(2)
    rs = _requests(Request, [(rng.integers(1, 500, size=9), [12]),
                                   (rng.integers(1, 500, size=9), [13])])
    port.prefill(rs, [False, True])
    for r in rs:
        r.state = RequestState.RUNNING
        r.out_tokens.append(7)
    both = port.decode(rs, [False, True])
    # decode writes the new token's KV at the same slot: rerunning one row
    # alone rewrites identical values, so its logits must repeat
    alone_dev = port.decode(rs[:1], [False])
    alone_host = port.decode(rs[1:], [True])
    np.testing.assert_allclose(alone_dev[0], both[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alone_host[0], both[1], rtol=1e-5, atol=1e-5)
