"""Plan-ahead scheduling and open-loop serving on the port's pipelined
engine, against the JAX package's: the scenarios of
``tests/test_planahead.py`` (plan-ahead vs lockstep for three policies, a
forced replan on arrival, an eos finish, ``offer`` admission, ``cancel``
freeing pages mid-flight, ``run_online`` streaming).  Same config, prompts
and bridged weights, the perf model frozen (``ewma_alpha=0``); tokens must
be identical request by request, and so must the plan-ahead counters.
Engines are closed in teardown."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.launch.serve import run_online as ref_run_online  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402
from repro.serving.traces import synthetic_trace as ref_synthetic_trace  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.request import RequestState  # noqa: E402
from repro_torch.launch.serve import run_online  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402
from repro_torch.serving.traces import synthetic_trace  # noqa: E402

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def weights():
    cfg_ref = ref_smoke(ARCH)
    params = ref_get_model(cfg_ref).init(jax.random.key(7))
    cfg = get_smoke_config(ARCH)
    return cfg_ref, params, cfg, params_from_reference(jax.tree.map(np.asarray, params), cfg)


@pytest.fixture
def build():
    made = []

    def make(w, *, side, policy="neo", planahead=True, device=7, host=96,
             max_batch_tokens=64, **kw):
        cfg_ref, params, cfg, state = w
        kw = dict(hw_profile="h100_sxm", ewma_alpha=0.0, device_pool_pages=device,
                  host_pool_pages=host, max_batch_tokens=max_batch_tokens, policy=policy,
                  planahead=planahead, **kw)
        if side == "ref":
            eng = RefEngine(cfg_ref, RefEngineConfig(**kw), params=params)
        else:
            eng = NeoEngine(cfg, EngineConfig(**kw), params=state, device="cpu")
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 500, size=n))) for n in sizes]


def _run(eng, prompts, n, max_iters=300, eos=None):
    rids = [eng.submit(p, n, eos_token=eos) for p in prompts]
    done = eng.run_until_done(max_iters)
    return [done[r] for r in rids]


@pytest.mark.parametrize("policy", ["neo", "gpu_only", "fastdecode"])
def test_planahead_matches_lockstep_and_reference(policy, weights, build):
    """Plan-ahead on vs off on the port and on the reference: identical
    tokens, and the speculation fires (hits > 0) as often as the
    reference's."""
    prompts = _prompts(30, (7, 19, 26, 12))
    port_on = build(weights, side="port", policy=policy)
    port_off = build(weights, side="port", policy=policy, planahead=False)
    ref_on = build(weights, side="ref", policy=policy)
    outs = [_run(e, prompts, 8) for e in (port_on, port_off, ref_on)]
    assert outs[0] == outs[1] == outs[2]
    assert port_on.stats.planahead_hits > 0 and port_off.stats.planahead_hits == 0
    s, r = port_on.stats, ref_on.stats
    assert (s.planahead_hits, s.planahead_replans, s.planahead_skipped) == \
        (r.planahead_hits, r.planahead_replans, r.planahead_skipped)
    assert s.planahead_hidden_time >= 0.0


def test_planahead_forced_replan_on_arrival(weights, build):
    """An arrival while a speculative plan is in flight falsifies it: a
    replan, and every request's tokens still equal the reference's."""
    prompts = _prompts(31, (9, 14))
    late = _prompts(32, (11,))[0]
    ref = build(weights, side="ref", planahead=False)
    want = _run(ref, prompts + [late], 8)
    eng = build(weights, side="port")
    a, b = (eng.submit(p, 8) for p in prompts)
    for _ in range(50):
        eng.step()
        if eng._spec is not None:
            break
    assert eng._spec is not None, "speculation never launched"
    c = eng.submit(late, 8)
    before = eng.stats.planahead_replans
    eng.step()  # stale signature: the waitqueue grew behind the planner's back
    assert eng.stats.planahead_replans == before + 1
    out = eng.run_until_done(300)
    assert [out[a], out[b], out[c]] == want


def test_planahead_eos_finish_replans(weights, build):
    """An eos stop is not predicted: it falsifies the signature and the
    output still stops exactly at eos, as the reference's does."""
    p = _prompts(33, (9,))
    probe = build(weights, side="port", planahead=False, device=16, host=16)
    seq = _run(probe, p, 6)[0]
    eos = seq[2]
    stop = seq.index(eos) + 1
    port = build(weights, side="port", device=16, host=16)
    ref = build(weights, side="ref", device=16, host=16)
    got, want = _run(port, p, 6, eos=eos), _run(ref, p, 6, eos=eos)
    assert got == want == [seq[:stop]]


def test_offer_admission_control(weights, build):
    p = _prompts(34, (6, 6, 6))
    outs = []
    for side in ("port", "ref"):
        eng = build(weights, side=side, max_waiting=1, device=16, host=32)
        first = eng.offer(p[0], 4)
        assert first is not None
        assert eng.offer(p[1], 4) is None and eng.offer(p[2], 4) is None
        assert eng.stats.rejected_requests == 2
        outs.append(eng.run_until_done(100)[first])
    assert outs[0] == outs[1] and len(outs[0]) == 4


def test_cancel_frees_pages_mid_flight(weights, build):
    p = _prompts(35, (8, 8))
    outs = []
    for side in ("port", "ref"):
        eng = build(weights, side=side, device=16, host=32)
        keep, victim = (eng.submit(q, 8) for q in p)
        free0 = eng.pool.device.free_pages + eng.pool.host.free_pages
        eng.step()
        eng.step()
        assert eng.cancel(victim)
        assert not eng.cancel(victim)  # already aborted
        assert not eng.requests[victim].pages
        outs.append(eng.run_until_done(200)[keep])
        assert eng.pool.device.free_pages + eng.pool.host.free_pages == free0
    assert outs[0] == outs[1] and len(outs[0]) == 8


def test_cancel_marks_aborted(weights, build):
    eng = build(weights, side="port", device=16, host=32)
    rid = eng.submit(_prompts(36, (8,))[0], 8)
    eng.step()
    assert eng.cancel(rid)
    assert eng.requests[rid].state == RequestState.ABORTED
    assert eng.scheduler.num_queued == 0


def test_run_online_streams_and_finishes(weights, build):
    """Open loop: mid-flight joins, streamed tokens == final tokens, TTFT /
    TPOT recorded, plan-ahead fires; the outputs are the reference
    runner's on the same trace."""
    port = build(weights, side="port", device=24, host=96, max_batch_tokens=256)
    streamed = {}
    m = run_online(port, synthetic_trace(6, 50.0, 12, 6, seed=3), vocab=500, seed=3,
                   on_token=lambda rid, t: streamed.setdefault(rid, []).append(t))
    finals = {rid: list(r.out_tokens) for rid, r in port.requests.items()}
    assert len(m.finished) == 6 and streamed == finals
    assert m.planahead_hits > 0
    for rec in m.finished:
        assert rec.ttft is not None and rec.ttft >= 0
        assert rec.tpot is None or rec.tpot > 0
    assert np.isfinite(m.ttft(99)) and np.isfinite(m.tpot(50))
    ref = build(weights, side="ref", device=24, host=96, max_batch_tokens=256)
    ref_run_online(ref, ref_synthetic_trace(6, 50.0, 12, 6, seed=3), vocab=500, seed=3)
    assert finals == {rid: list(r.out_tokens) for rid, r in ref.requests.items()}
