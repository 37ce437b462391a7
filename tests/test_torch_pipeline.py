"""The port's pipelined NeoEngine against the JAX package's pipelined
engine and against its own serial path: the engine scenarios of
``tests/test_transfer.py`` (async swaps under a tight device pool, the
overlap counters, the f16 host pool, serial-mode plans, starvation
preemption).  Same config, prompts and bridged weights on every side, the
perf model frozen (``ewma_alpha=0``) so the plans are the same; every
request's greedy tokens must be identical three ways.  Engines are closed
in teardown even when a test fails."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.engine import NeoEngine as RefEngine  # noqa: E402
from repro.core.perfmodel import PerfModel as RefPerfModel  # noqa: E402
from repro.core.request import Request as RefRequest  # noqa: E402
from repro.core.request import RequestState as RefState  # noqa: E402
from repro.core.scheduler import NeoScheduler as RefScheduler  # noqa: E402
from repro.core.scheduler import PoolView as RefPoolView  # noqa: E402
from repro.models.api import get_model as ref_get_model  # noqa: E402

from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import NeoEngine  # noqa: E402
from repro_torch.core.perfmodel import PerfModel  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.core.scheduler import NeoScheduler, PoolView  # noqa: E402
from repro_torch.models.bridge import params_from_reference  # noqa: E402

ARCH = "qwen3-0.6b"


def _weights(cfg_ref, seed):
    params = ref_get_model(cfg_ref).init(jax.random.key(seed))
    cfg = get_smoke_config(ARCH).replace(param_dtype=cfg_ref.param_dtype,
                                         activation_dtype=cfg_ref.activation_dtype)
    return cfg_ref, params, cfg, params_from_reference(jax.tree.map(np.asarray, params), cfg)


@pytest.fixture(scope="module")
def weights():
    return _weights(ref_smoke(ARCH), 7)


@pytest.fixture
def build():
    """``build(weights, pipeline, side, **ecfg)``: an engine of the
    reference (side "ref") or the port, closed in teardown."""
    made = []

    def make(w, *, side, pipeline=True, **ecfg):
        cfg_ref, params, cfg, state = w
        kw = dict(hw_profile="h100_sxm", ewma_alpha=0.0, pipeline=pipeline, **ecfg)
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


def _run(eng, prompts, n_new, max_iters=400):
    rids = [eng.submit(p, n_new) for p in prompts]
    out = eng.run_until_done(max_iters)
    return [out[r] for r in rids]


def _three_way(build, w, prompts, n_new, **ecfg):
    """Tokens of the reference's pipelined engine, the port's pipelined
    engine and the port's serial engine; returns (tokens, port engine)."""
    ref = build(w, side="ref", **ecfg)
    port = build(w, side="port", **ecfg)
    serial = build(w, side="port", **{**ecfg, "pipeline": False})
    outs = [_run(e, prompts, n_new) for e in (ref, port, serial)]
    assert outs[1] == outs[0], "port pipelined != reference pipelined"
    assert outs[1] == outs[2], "port pipelined != port serial"
    return outs[1], port, ref


@pytest.mark.parametrize("policy", ["neo", "fastdecode"])
def test_pipelined_matches_reference_and_serial(policy, weights, build):
    out, port, ref = _three_way(build, weights, _prompts(3, (9, 21, 33)), 7,
                                device_pool_pages=7, host_pool_pages=96,
                                max_batch_tokens=64, policy=policy)
    assert all(len(o) == 7 for o in out)
    assert port.stats.mode_counts == ref.stats.mode_counts
    assert port.stats.offloaded_decodes == ref.stats.offloaded_decodes


def test_async_swap_completes_before_dependent_decode(weights, build):
    """Swap pressure: every decode after a swap reads the moved pages, so
    the tokens stay exact under a tiny device pool, and the swap traffic is
    the reference's byte for byte."""
    _, port, ref = _three_way(build, weights, _prompts(11, (24, 30, 18, 22)), 6,
                              device_pool_pages=7, host_pool_pages=128,
                              max_batch_tokens=128, policy="neo")
    s = port.stats
    assert s.offloaded_decodes > 0 and s.swap_out_bytes > 0
    assert (s.swap_out_bytes, s.swap_in_bytes) == (ref.stats.swap_out_bytes,
                                                   ref.stats.swap_in_bytes)
    assert port.pool.swap_bytes == ref.pool.swap_bytes
    assert all(r.state == RequestState.FINISHED for r in port.requests.values())


def test_pipelined_overlap_metrics(weights, build):
    """Measured overlap: host lanes concurrent with the device lane, swap
    bytes hidden under the dispatch window, bubble fraction in [0, 1]."""
    port = build(weights, side="port", device_pool_pages=7, host_pool_pages=128,
                 max_batch_tokens=128, policy="neo")
    ref = build(weights, side="ref", device_pool_pages=7, host_pool_pages=128,
                max_batch_tokens=128, policy="neo")
    prompts = _prompts(5, (24, 30, 18, 22, 26, 28))
    assert _run(port, prompts, 6) == _run(ref, prompts, 6)
    s = port.stats
    assert s.pipelined_steps > 0 and s.pipeline_overlap_time > 0.0
    assert s.swap_hidden_bytes > 0
    assert s.host_busy_time > 0.0 and s.device_busy_time > 0.0
    assert 0.0 <= s.bubble_fraction <= 1.0
    assert s.pipelined_steps == ref.stats.pipelined_steps
    assert s.lane_counts == ref.stats.lane_counts


def test_f16_host_pool_pipelined_equality(build):
    """A bf16 arch keeps its host pool in f16; the pipelined fastdecode run
    (every decode offloaded) emits the reference's and the serial path's
    tokens."""
    cfg_ref = ref_smoke(ARCH)
    cfg_ref = cfg_ref.replace(name="bf16-smoke", param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    w = _weights(cfg_ref, 1)
    _, port, _ = _three_way(build, w, _prompts(4, (9, 22, 30)), 5,
                            device_pool_pages=7, host_pool_pages=96,
                            max_batch_tokens=64, policy="fastdecode")
    assert port.pool.host.k.dtype == torch.float16
    assert port.stats.offloaded_decodes > 0


def test_serial_mode_plans_stay_serial(weights, build):
    """policy="simple" (strawman #1) never pipelines, even with the engine's
    default pipeline=True: its plans are mode="serial"."""
    _, port, _ = _three_way(build, weights, _prompts(9, (12,)), 5,
                            device_pool_pages=8, host_pool_pages=64,
                            max_batch_tokens=64, policy="simple")
    assert port.stats.pipelined_steps == 0
    assert set(port.stats.mode_counts) == {"serial"}


def _starving(sched_cls, req_cls, state, view_cls, ecfg_cls, perf_cls, cfg):
    """tests/test_transfer.py's starvation scenario on one side: returns the
    plan summaries until the first preemption."""
    ecfg = ecfg_cls(device_pool_pages=4, host_pool_pages=4, max_batch_tokens=256,
                    starvation_limit=3, policy="neo", hw_profile="h100_sxm")
    sched = sched_cls(cfg, ecfg, perf_cls.for_arch(cfg, ecfg.hw_profile))
    page = cfg.kv_block_size
    for rid in range(2):
        r = req_cls(rid=rid, prompt=list(range(2 * page)), max_new_tokens=8)
        r.state = state.RUNNING
        r.location = "cpu"
        r.pages = [2 * rid, 2 * rid + 1]
        r.out_tokens = [1]  # kv_len == 2 * page: the next token needs a page
        sched.cpu_runq.append(r)
    plans = []
    for _ in range(ecfg.starvation_limit + 1):
        plan = sched.plan(view_cls(page_size=page, device_free=0, host_free=0,
                                   device_total=4, host_total=4))
        plans.append((plan.summary(), [r.rid for r in plan.preempt],
                      sorted(r.rid for r in plan.host_rows)))
        if plan.preempt:
            break
    return plans


def test_starvation_preemption_drains_full_host_pool():
    """Host rows that cannot get their next page are skipped, then
    recompute-preempted after ``starvation_limit`` skips so the full host
    pool drains; the port's scheduler makes the reference's plans."""
    port = _starving(NeoScheduler, Request, RequestState, PoolView, EngineConfig,
                     PerfModel, get_smoke_config(ARCH))
    ref = _starving(RefScheduler, RefRequest, RefState, RefPoolView, RefEngineConfig,
                    RefPerfModel, ref_smoke(ARCH))
    assert port == ref
    summary, victims, host_rows = port[-1]
    assert len(victims) == 1 and host_rows == [1 - victims[0]]
