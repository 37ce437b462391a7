"""Unified lane plans and micro-batching on the port's pipelined engine,
against the JAX package's pipelined engine and the port's own serial path:
the scenarios of ``tests/test_lane_plans.py`` (random lane plans, with
preemption, a forced three-lane plan, borrowed lanes, ``max_host_lanes=2``,
the executed-K histogram) and ``tests/test_engine_microbatch.py`` (micro-
batch on/off, mixed plans, mid-stream preemption, NaN-free stats, lane busy
accounting).  Same config, prompts and bridged weights, the perf model
frozen (``ewma_alpha=0``); every request's greedy tokens must be identical.
Where a scenario injects lane plans, both engines get the same injection
(the same seeded generator).  Engines are closed in teardown."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_config as ref_full_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.core.perfmodel import PerfModel as RefPerfModel  # noqa: E402
from repro.core.request import Request as RefRequest  # noqa: E402
from repro.core.request import RequestState as RefState  # noqa: E402
from repro.core.scheduler import NeoScheduler as RefScheduler  # noqa: E402
from repro.core.scheduler import PoolView as RefPoolView  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.engine import EngineStats, NeoEngine  # noqa: E402
from repro_torch.core.perfmodel import PerfModel  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.core.scheduler import NeoScheduler, PoolView  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402

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

    def make(w, *, side, **ecfg):
        cfg_ref, params, cfg, state = w
        kw = dict(hw_profile="h100_sxm", ewma_alpha=0.0, max_batch_tokens=256, **ecfg)
        if side == "ref":
            eng = RefEngine(cfg_ref, RefEngineConfig(**kw), params=params)
        else:
            eng = NeoEngine(cfg, EngineConfig(**kw), params=state, device="cpu")
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 500, size=n))) for n in lens]


def _run(eng, prompts, n_out, max_iters=500):
    rids = [eng.submit(p, n_out) for p in prompts]
    done = eng.run_until_done(max_iters)
    return [done[r] for r in rids]


def _random_lanes(eng, seed):
    """tests/test_lane_plans.py's random lane plans: random K in [2,
    max_host_lanes], random contiguous boundaries, from a seeded generator."""
    t_rng = np.random.default_rng(seed)
    kmax = eng.engine_cfg.max_host_lanes

    def random_annotate(plan) -> None:
        plan.lane_splits = []
        n = len(plan.decode_cpu1)
        if n < 2:
            return
        k = int(t_rng.integers(2, min(kmax, n) + 1))
        bounds = t_rng.choice(np.arange(1, n), size=k - 1, replace=False)
        plan.lane_splits = sorted(int(b) for b in bounds)

    eng.scheduler._annotate_lanes = random_annotate


def _three_lanes(eng):
    def three_lanes(plan) -> None:
        plan.lane_splits = []
        n = len(plan.decode_cpu1)
        if n >= 3:
            a = max(1, n // 3)
            plan.lane_splits = [a, max(a + 1, 2 * n // 3)]

    eng.scheduler._annotate_lanes = three_lanes


def _compare(build, w, prompts, n_out, patch=None, **ecfg):
    """Reference pipelined vs port pipelined (both patched alike) vs port
    serial: identical tokens.  Returns (port stats, reference stats)."""
    ref = build(w, side="ref", pipeline=True, **ecfg)
    port = build(w, side="port", pipeline=True, **ecfg)
    serial = build(w, side="port", pipeline=False, **ecfg)
    if patch is not None:
        patch(ref)
        patch(port)
    outs = [_run(e, prompts, n_out) for e in (ref, port, serial)]
    assert outs[1] == outs[0], "port pipelined != reference pipelined"
    assert outs[1] == outs[2], "port pipelined != port serial"
    return port.stats, ref.stats


# ---------------------------------------------------------------------------
# tests/test_lane_plans.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,seed", [("fastdecode", 0), ("neo", 1)])
def test_random_lane_plans(weights, build, policy, seed):
    if policy == "neo":
        prompts = _prompts(seed, (30,) * 5)
        pages = dict(device_pool_pages=11, host_pool_pages=128)
    else:
        prompts = _prompts(seed, (20, 33, 27, 18, 25))
        pages = dict(device_pool_pages=8, host_pool_pages=128)
    stats, ref_stats = _compare(build, weights, prompts, 8,
                                patch=lambda e: _random_lanes(e, seed + 100),
                                policy=policy, **pages)
    assert any(k >= 2 for k in stats.lane_counts), "no multi-lane step ran"
    assert stats.lane_counts == ref_stats.lane_counts


def test_random_lane_plans_with_preemption(weights, build):
    """Mid-stream recompute preemption under random lane plans: preempted
    rows vanish from their lane, every request still finishes."""
    stats, _ = _compare(build, weights, _prompts(5, (22, 26, 24)), 10,
                        patch=lambda e: _random_lanes(e, 42), policy="fastdecode",
                        device_pool_pages=8, host_pool_pages=6, starvation_limit=2)
    preempts = sum(int(s.split("preempt=")[1].split()[0]) for s in stats.plans)
    assert preempts > 0, "scenario must actually preempt"


def test_three_lane_plan_executes(weights, build):
    stats, _ = _compare(build, weights, _prompts(9, (20, 24, 28, 18, 22, 26)), 8,
                        patch=_three_lanes, policy="fastdecode",
                        device_pool_pages=8, host_pool_pages=128)
    assert stats.lane_counts.get(3, 0) > 0
    for lane in ("host0", "host1", "host2"):
        assert stats.lane_busy_time.get(lane, 0) > 0


def test_short_device_lane_borrows_lanes(weights, build):
    """Lockstep decode under device pressure: the swap-out burst yields a
    mixed decode-only plan whose surplus host rows borrow host lanes."""
    stats, ref_stats = _compare(build, weights, _prompts(3, (30,) * 5), 8,
                                policy="neo", device_pool_pages=11, host_pool_pages=128)
    assert stats.borrowed_lane_steps > 0
    assert stats.borrowed_lane_steps == ref_stats.borrowed_lane_steps
    assert stats.lane_busy_time.get("batch0", 0) > 0
    assert stats.lane_busy_time.get("host1", 0) > 0


def _host_row(req_cls, state, page, rid, kv_tokens):
    r = req_cls(rid=rid, prompt=[1] * kv_tokens, max_new_tokens=16, arrival_time=float(rid))
    r.state = state.RUNNING
    r.location = "cpu"
    r.out_tokens = [0]
    r.pages = [0] * (-(-(r.kv_len + 1) // page))
    return r


def test_max_host_lanes_two_matches_reference():
    """max_host_lanes=2 gives one boundary at the micro-batch argmin; the
    port's scheduler picks the reference's split for the same rows."""
    splits = []
    for sched_cls, perf_cls, ecfg_cls, req_cls, state, view_cls, cfg in (
            (NeoScheduler, PerfModel, EngineConfig, Request, RequestState, PoolView,
             get_config(ARCH)),
            (RefScheduler, RefPerfModel, RefEngineConfig, RefRequest, RefState,
             RefPoolView, ref_full_config(ARCH))):
        ecfg = ecfg_cls(device_pool_pages=64, host_pool_pages=256, max_batch_tokens=2048,
                        policy="fastdecode", max_host_lanes=2, hw_profile="h100_sxm")
        s = sched_cls(cfg, ecfg, perf_cls.for_arch(cfg, "h100_sxm"))
        for i, kv in enumerate([40, 200, 80, 120, 60]):
            s.cpu_runq.append(_host_row(req_cls, state, cfg.kv_block_size, 100 + i, kv))
        plan = s.plan(view_cls(cfg.kv_block_size, 64, 1 << 20))
        splits.append((plan.lane_splits, plan.microbatch, plan.microbatch_split))
    assert splits[0] == splits[1]
    assert len(splits[0][0]) == 1 and splits[0][1]


def test_lane_counts_record_executed_k(weights, build):
    """A K=2 plan whose second lane is preempted between plan and launch
    runs serialised with K=1: the histogram records the executed K."""
    eng = build(weights, side="port", pipeline=True, policy="fastdecode",
                device_pool_pages=64, host_pool_pages=128, max_host_lanes=2,
                planahead=False)
    for p in _prompts(11, (24,) * 4):
        eng.submit(p, 8)
    for _ in range(3):
        eng.step(now=eng.clock + 1e-3)
    assert eng.stats.lane_counts.get(2, 0) > 0
    orig_plan = eng.scheduler.plan
    injected = {}

    def preempting_plan(pools):
        plan = orig_plan(pools)
        lanes = plan.host_lanes()
        if plan.lane_splits and len(lanes) >= 2 and not injected:
            plan.preempt.extend(lanes[1])
            injected["planned_k"] = plan.num_host_lanes
        return plan

    eng.scheduler.plan = preempting_plan
    before = dict(eng.stats.lane_counts)
    mb_before, serial_before = eng.stats.microbatched_steps, eng.stats.serial_b1_steps
    eng.step(now=eng.clock + 1e-3)
    assert injected.get("planned_k") == 2
    delta = {k: eng.stats.lane_counts.get(k, 0) - before.get(k, 0)
             for k in set(eng.stats.lane_counts) | set(before)}
    assert delta.get(2, 0) == 0 and delta.get(1, 0) == 1
    assert eng.stats.microbatched_steps == mb_before
    assert eng.stats.serial_b1_steps == serial_before + 1
    eng.scheduler.plan = orig_plan
    eng.run_until_done()
    assert all(r.state.name in ("FINISHED", "ABORTED") for r in eng.requests.values())


# ---------------------------------------------------------------------------
# tests/test_engine_microbatch.py
# ---------------------------------------------------------------------------


def test_fastdecode_microbatch_on_off(weights, build):
    """Batch-1-only plans split into micro-batches change no token, and
    realize overlap the inline path cannot."""
    prompts = _prompts(20, (20, 33, 27, 18))
    kw = dict(policy="fastdecode", device_pool_pages=8, host_pool_pages=128,
              planahead=False)
    on, ref_on = _compare(build, weights, prompts, 8, microbatch=True, **kw)
    off, _ = _compare(build, weights, prompts, 8, microbatch=False, **kw)
    assert on.microbatched_steps > 0 and on.microbatched_steps == ref_on.microbatched_steps
    assert off.microbatched_steps == 0 and off.serial_b1_steps > 0
    assert on.pipeline_overlap_time > 0 and off.pipeline_overlap_time == 0
    assert on.bubble_fraction < off.bubble_fraction
    assert on.lane_busy_time.get("host0", 0) > 0 and on.lane_busy_time.get("host1", 0) > 0
    assert on.borrowed_lane_steps == 0


def test_mixed_neo_plans_microbatch_on_off(weights, build):
    prompts = _prompts(21, (24, 30, 18, 22))
    for mb in (True, False):
        _compare(build, weights, prompts, 8, policy="neo", microbatch=mb,
                 device_pool_pages=7, host_pool_pages=128, planahead=False)


def test_microbatch_preemption_midstream(weights, build):
    stats, _ = _compare(build, weights, _prompts(22, (22, 26, 24)), 10,
                        policy="fastdecode", microbatch=True, device_pool_pages=8,
                        host_pool_pages=6, starvation_limit=2, planahead=False)
    preempts = sum(int(s.split("preempt=")[1].split()[0]) for s in stats.plans)
    assert preempts > 0 and stats.microbatched_steps > 0


def test_stats_empty_lane_nan_free():
    s = EngineStats()
    assert s.bubble_fraction == 0.0 and s.host_device_busy_ratio == 0.0
    s.host_busy_time = 1.5
    assert s.host_device_busy_ratio == float("inf")
    s.device_busy_time = 3.0
    assert s.host_device_busy_ratio == 0.5
    s.pipeline_ideal_time, s.pipeline_overlap_time = 2.0, 0.0
    assert s.bubble_fraction == 1.0
    s.pipeline_overlap_time = 5.0  # jitter past ideal clamps at 0
    assert s.bubble_fraction == 0.0
    assert not any(math.isnan(x) for x in (s.bubble_fraction, s.host_device_busy_ratio))


def test_lane_busy_accounting(weights, build):
    prompts = _prompts(23, (20, 25))
    serial = build(weights, side="port", pipeline=False, policy="neo",
                   device_pool_pages=16, host_pool_pages=128, planahead=False)
    pipe = build(weights, side="port", pipeline=True, policy="neo",
                 device_pool_pages=16, host_pool_pages=128, planahead=False)
    assert _run(serial, prompts, 8) == _run(pipe, prompts, 8)
    assert serial.stats.lane_busy_time.get("prefill", 0) > 0
    assert serial.stats.lane_busy_time.get("serial", 0) > 0
    assert pipe.stats.lane_busy_time.get("batch0", 0) > 0
