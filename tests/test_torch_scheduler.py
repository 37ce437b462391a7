"""The port's scheduler and perf model against the JAX package's: both plan
the same scripted states in lockstep (a page-exact virtual executor applies
each plan to both sides) with the perf model frozen, and every BatchPlan —
modes, the gpu/cpu split, swaps, preemptions, lane splits and estimates —
must be identical."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.config import EngineConfig as RefEngineConfig  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.perfmodel import PerfModel as RefPerfModel  # noqa: E402
from repro.core.request import Request as RefRequest  # noqa: E402
from repro.core.request import RequestState as RefState  # noqa: E402
from repro.core.scheduler import NeoScheduler as RefScheduler  # noqa: E402
from repro.core.scheduler import PoolView as RefPoolView  # noqa: E402

from repro_torch.testing import one_thread  # noqa: E402,F401
from repro_torch.config import EngineConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.perfmodel import PerfModel  # noqa: E402
from repro_torch.core.request import Request, RequestState  # noqa: E402
from repro_torch.core.scheduler import NeoScheduler, PoolView  # noqa: E402

ARCH = "qwen3-0.6b"
HW = "h100_sxm"


class Side:
    """One scheduler plus a page-exact virtual executor (the bookkeeping of
    ``tests/test_scheduler.py``'s Harness)."""

    def __init__(self, sched_cls, perf_cls, ecfg_cls, cfg, req_cls, state, view_cls,
                 policy, device, host, max_tokens):
        ecfg = ecfg_cls(device_pool_pages=device, host_pool_pages=host,
                        max_batch_tokens=max_tokens, policy=policy, ewma_alpha=0.0,
                        hw_profile=HW)
        self.s = sched_cls(cfg, ecfg, perf_cls.for_arch(cfg, HW, 0.0))
        self.req_cls, self.state, self.view_cls = req_cls, state, view_cls
        self.device_free, self.host_free = device, host
        self.totals = (device, host)
        self.page = cfg.kv_block_size

    def add(self, rid, prompt_len, max_new):
        self.s.add_request(self.req_cls(rid=rid, prompt=[1] * prompt_len,
                                        max_new_tokens=max_new, arrival_time=float(rid)))

    def step(self):
        plan = self.s.plan(self.view_cls(self.page, self.device_free, self.host_free,
                                         device_total=self.totals[0],
                                         host_total=self.totals[1]))
        if plan.is_empty():
            return None
        sig = _signature(plan)
        for r in plan.preempt:
            self._free(r)
        for r in plan.swap_out:
            self.device_free += len(r.pages)
            self.host_free -= len(r.pages)
            r.location = "cpu"
        for r in plan.swap_in:
            self.host_free += len(r.pages)
            self.device_free -= len(r.pages)
            r.location = "gpu"
        self.s.commit(plan)
        for r in plan.prefill:
            n = -(-r.prefill_len // self.page)
            if r in plan.prefill_to_host:
                self.host_free -= n
            else:
                self.device_free -= n
            r.pages = [0] * n
            if not r.out_tokens:
                r.out_tokens.append(0)
        for r in plan.decode_rows:
            if r in plan.prefill or r.state != self.state.RUNNING:
                continue
            if r.kv_len % self.page == 0 and r.kv_len // self.page >= len(r.pages):
                if r.location == "cpu":
                    self.host_free -= 1
                else:
                    self.device_free -= 1
                r.pages = r.pages + [0]
            r.out_tokens.append(0)
        for r in plan.prefill + plan.decode_rows:
            if r.state == self.state.RUNNING and r.is_done():
                r.state = self.state.FINISHED
                self._free(r)
        self.s.remove_finished()
        assert self.device_free >= 0 and self.host_free >= 0
        return sig

    def _free(self, r):
        if r.location == "cpu":
            self.host_free += len(r.pages)
        else:
            self.device_free += len(r.pages)
        r.pages = []
        r.location = "gpu"


def _signature(plan):
    ids = lambda rs: tuple(r.rid for r in rs)  # noqa: E731
    return (plan.mode, ids(plan.prefill), ids(plan.prefill_to_host),
            ids(plan.decode_gpu), ids(plan.decode_cpu0), ids(plan.decode_cpu1),
            ids(plan.swap_out), ids(plan.swap_in), ids(plan.preempt),
            tuple(plan.lane_splits), plan.spec_k, plan.est_tokens,
            round(plan.est_iter_time, 12))


def _pair(policy, device, host, max_tokens):
    ref = Side(RefScheduler, RefPerfModel, RefEngineConfig, ref_get_config(ARCH),
               RefRequest, RefState, RefPoolView, policy, device, host, max_tokens)
    port = Side(NeoScheduler, PerfModel, EngineConfig, get_config(ARCH), Request,
                RequestState, PoolView, policy, device, host, max_tokens)
    return ref, port


def _lockstep(ref, port, max_iters=3000):
    n = 0
    for _ in range(max_iters):
        a, b = ref.step(), port.step()
        assert b == a, f"plan {n} diverged:\nref  {a}\nport {b}"
        if a is None:
            break
        n += 1
    assert ref.s.num_queued == port.s.num_queued == 0
    return n


SCENARIOS = {
    # name: (policy, device pages, host pages, max batch tokens, requests)
    "neo-roomy": ("neo", 64, 256, 2048, [(100, 16)] * 10),
    "neo-tight": ("neo", 8, 64, 512, [(60, 24)] * 8),
    "neo-preempt": ("neo", 6, 6, 256, [(40, 30), (50, 20), (30, 40), (45, 10)]),
    "gpu_only": ("gpu_only", 16, 128, 512, [(100, 16)] * 10),
    "fastdecode": ("fastdecode", 64, 256, 2048, [(50, 8)] * 6),
    "simple": ("simple", 16, 128, 512, [(80, 12)] * 6),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plans_identical_to_reference(name):
    policy, device, host, max_tokens, reqs = SCENARIOS[name]
    ref, port = _pair(policy, device, host, max_tokens)
    for side in (ref, port):
        for rid, (pl, mx) in enumerate(reqs):
            side.add(rid, pl, mx)
    assert _lockstep(ref, port) > 0


@pytest.mark.parametrize("policy", ["neo", "fastdecode"])
def test_random_mixes_identical_to_reference(policy):
    rng = np.random.default_rng(0)
    for trial in range(3):
        ref, port = _pair(policy, 32, 160, 1024)
        reqs = [(int(rng.integers(1, 400)), int(rng.integers(1, 64)))
                for _ in range(int(rng.integers(4, 20)))]
        for side in (ref, port):
            for rid, (pl, mx) in enumerate(reqs):
                side.add(rid, pl, mx)
        _lockstep(ref, port)


def test_host_lane_split_identical_to_reference():
    """Scripted host-resident rows with long KV: the perf model splits
    batch-1 into several lanes, identically on both sides."""
    plans = []
    for side in _pair("fastdecode", 64, 1 << 20, 2048):
        for i in range(6):
            r = side.req_cls(rid=100 + i, prompt=[1] * 20_000, max_new_tokens=16)
            r.state = side.state.RUNNING
            r.location = "cpu"
            r.out_tokens = [0]
            r.pages = [0] * (-(-(r.kv_len + 1) // side.page))
            side.s.cpu_runq.append(r)
        plans.append(side.step())
    assert plans[0] == plans[1]
    assert len(plans[1][9]) >= 2  # >= 3 lanes


def test_admission_identical_to_reference():
    plans = []
    for side in _pair("neo", 4, 4, 64):
        side.add(0, 199, 8)  # fits no pool: aborted by admission control
        side.add(1, 4, 4)
        plans.append([side.step() for _ in range(6)])
        assert [r.state.value for r in side.s.waitq] == []
    assert plans[0] == plans[1]

