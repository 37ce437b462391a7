"""Decode row buckets of the port's PagedExecutor on the CPU.

Every decode pass -- the serial/batch-0 pass and each host lane -- pads its
rows to the reference's bucket (``repro.core.executor._bucket``: powers of
two, at least 8) before the first GEMM, so that the GEMMs run at the same M
whatever the row count within a bucket.  Padded rows (token 0, position 0,
``lens = 0``) must not change the real rows' logits, must never write to
either pool, and must never reach host attention.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import executor as ex_mod  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402

CFG = get_smoke_config("qwen3-0.6b")


@pytest.fixture
def engine():
    eng = NeoEngine(CFG, EngineConfig(device_pool_pages=96, host_pool_pages=96, policy="neo",
                                      pipeline=False, hw_profile="h100_sxm", seed=0),
                    device="cpu")
    g = torch.Generator().manual_seed(1)
    for t in (eng.pool.device.k, eng.pool.device.v, eng.pool.host.k, eng.pool.host.v):
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))  # in place: views stay
    yield eng
    eng.close()


def _rows(eng, specs, seed):
    rng = np.random.default_rng(seed)
    page, out = CFG.kv_block_size, []
    for rid, (n, loc) in enumerate(specs):
        r = Request(rid=rid, prompt=list(map(int, rng.integers(1, CFG.vocab_size, n))),
                    max_new_tokens=4)
        r.state = RequestState.RUNNING
        r.location = loc
        r.out_tokens = [int(rng.integers(1, CFG.vocab_size))]
        r.pages = eng.pool.pool(loc).alloc(-(-(r.kv_len + 1) // page))
        out.append(r)
    return out


def _written_slots(eng, rows, loc):
    page = CFG.kv_block_size
    return {(r.pages[r.kv_len // page], r.kv_len % page) for r in rows if r.location == loc}


def _count_rows(eng, monkeypatch):
    """Record the row count of every final_logits call (the logits GEMM's M)."""
    seen = []
    fn = eng.model.final_logits

    def spy(x):
        seen.append(x.shape[0])
        return fn(x)

    monkeypatch.setattr(eng.model, "final_logits", spy)
    return seen


def test_bucket_is_the_reference_bucket():
    jax_ex = pytest.importorskip("repro.core.executor")
    for n in range(0, 300):
        assert ex_mod._bucket(n) == jax_ex._bucket(n), n


@pytest.mark.parametrize("specs", [
    [(20, "gpu")],
    [(20, "gpu"), (35, "cpu"), (17, "gpu")],
    [(n, "gpu" if i % 3 else "cpu") for i, n in enumerate(range(17, 17 + 9 * 5, 5))],  # 9 rows
])
def test_decode_pads_to_bucket_and_keeps_the_rows_logits(specs, engine, monkeypatch):
    """The serial/batch-0 pass runs its GEMMs at the bucket's M, and the n
    real rows' logits equal those of the same pass without padding."""
    eng = engine
    rows = _rows(eng, specs, seed=len(specs))
    flags = [r.location == "cpu" for r in rows]
    seen = _count_rows(eng, monkeypatch)
    padded = eng.executor.decode(rows, flags)
    assert seen == [ex_mod._bucket(len(rows))]
    assert padded.shape == (len(rows), CFG.vocab_size)
    monkeypatch.setattr(ex_mod, "_bucket", lambda n: n)
    plain = eng.executor.decode(rows, flags)
    assert seen[-1] == len(rows)
    np.testing.assert_allclose(padded, plain, rtol=1e-5, atol=1e-5)
    assert (padded.argmax(-1) == plain.argmax(-1)).all()


@pytest.mark.parametrize("n", [1, 3, 9])
def test_host_lane_pads_to_bucket_and_keeps_the_rows_logits(n, engine, monkeypatch):
    """A host lane runs its GEMMs at the bucket's M; host attention sees
    only the n real rows; their logits equal the unpadded lane's."""
    eng = engine
    rows = _rows(eng, [(20 + 7 * i, "cpu") for i in range(n)], seed=n)
    seen = _count_rows(eng, monkeypatch)
    attended = []
    run_layer = eng.executor.host.run_layer

    def spy(li, q, k, v, **kw):
        attended.append(q.shape[0])
        return run_layer(li, q, k, v, **kw)

    monkeypatch.setattr(eng.executor.host, "run_layer", spy)
    padded = eng.executor.decode_host_lane(rows)
    assert seen == [ex_mod._bucket(n)]
    assert attended == [n] * CFG.num_layers
    monkeypatch.setattr(ex_mod, "_bucket", lambda m: m)
    plain = eng.executor.decode_host_lane(rows)
    np.testing.assert_allclose(padded, plain, rtol=1e-5, atol=1e-5)


def test_padded_rows_never_write_to_either_pool(engine):
    """Only the real rows' new-token slots change, in their own pool; the
    padded rows (position 0 of page 0 if they wrote anywhere) leave both
    pools untouched, in the serial pass and in a host lane."""
    eng = engine
    rows = _rows(eng, [(20, "gpu"), (33, "cpu"), (18, "gpu")], seed=3)
    lane_rows = _rows(eng, [(21, "cpu"), (40, "cpu")], seed=4)
    before = {name: t.clone() for name, t in (("dk", eng.pool.device.k),
                                              ("dv", eng.pool.device.v),
                                              ("hk", eng.pool.host.k),
                                              ("hv", eng.pool.host.v))}
    eng.executor.decode(rows, [r.location == "cpu" for r in rows])
    eng.executor.decode_host_lane(lane_rows)
    allowed = {"d": _written_slots(eng, rows, "gpu"),
               "h": _written_slots(eng, rows + lane_rows, "cpu")}
    for name, old in before.items():
        new = getattr(eng.pool.device if name[0] == "d" else eng.pool.host, name[1])
        changed = (new != old).reshape(*old.shape[:3], -1).any(-1).any(0)  # [P, page]
        got = {(int(p), int(o)) for p, o in zip(*np.nonzero(changed.numpy()))}
        assert got <= allowed[name[0]], (name, got - allowed[name[0]])
        assert got, name  # the real rows did write
