"""Discrete-event serving simulator (the port's copy of the JAX package's
``serving/simulator.py``; plain Python, it runs no kernel and no model).

Drives the **real** :class:`NeoScheduler` (the exact production scheduling
code) over a virtual clock; only stage *durations* come from the calibrated
:class:`PerfModel` — this is how the reference's paper figures
(``benchmarks/fig6_load_latency.py`` to ``fig10a_cpu.py``) come about for
the T4/A10G/H100 testbeds without those accelerators.  Its numbers are the
perf model's predictions, never measurements.

Pool sizing mirrors the paper's setups: the device pool gets whatever HBM
remains after model weights (+10% activation headroom); the host pool gets
the host DRAM budget.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.config import ArchConfig, EngineConfig
from repro_torch.core.perfmodel import PerfModel
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import NeoScheduler, PoolView
from repro_torch.roofline.hw import HardwareProfile, get_profile
from repro_torch.serving.metrics import RequestRecord, ServeMetrics
from repro_torch.serving.traces import TraceRequest


class FakePool:
    """Page accounting without arrays (the simulator's PagePool)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"sim pool out of pages ({n} > {len(self._free)})")
        out, self._free = self._free[:n], self._free[n:]
        return out

    def free(self, pages: List[int]) -> None:
        self._free.extend(pages)


def size_pools(
    cfg: ArchConfig, hw: HardwareProfile, *, tp: int = 1,
    device_kv_bytes: int = 2, host_kv_bytes: int = 2,
    activation_headroom: float = 0.10,
) -> Tuple[int, int]:
    """(device_pages, host_pages) from the hardware budget, paper-style.

    ``tp``-way tensor parallelism splits both the weights and the KV heads, so
    per-device budgets scale down together (the paper's 2×H100 / 70B setup).
    """
    page = cfg.kv_block_size
    params_bytes = cfg.param_count() * 2 / tp
    kv_tok_dev = cfg.kv_bytes_per_token(device_kv_bytes) / tp
    kv_tok_host = cfg.kv_bytes_per_token(host_kv_bytes) / tp
    usable = hw.device_hbm_bytes * (1 - activation_headroom) - params_bytes
    device_pages = max(int(usable / (kv_tok_dev * page)), 0)
    host_pages = max(int(hw.host_mem_bytes / (kv_tok_host * page)), 0)
    return device_pages, host_pages


@dataclass
class SimEngine:
    """Virtual-time engine: real scheduler, modelled execution."""

    cfg: ArchConfig
    engine_cfg: EngineConfig
    device_pages: int
    host_pages: int
    iter_overhead: float = 2e-3  # scheduling + launch + sampling per iteration
    tp: int = 1

    def __post_init__(self) -> None:
        self.perf = PerfModel.for_arch(
            self.cfg, self.engine_cfg.hw_profile, self.engine_cfg.ewma_alpha, tp=self.tp
        )
        self.scheduler = NeoScheduler(self.cfg, self.engine_cfg, self.perf)
        self.device = FakePool(self.device_pages)
        self.host = FakePool(self.host_pages)
        self.clock = 0.0
        self.metrics = ServeMetrics()
        self._records: Dict[int, RequestRecord] = {}
        self._next_rid = 0

    # ------------------------------------------------------------------
    def submit(self, tr: TraceRequest) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(
            rid=rid,
            prompt=[0] * tr.prompt_len,  # token values are irrelevant here
            max_new_tokens=tr.output_len,
            arrival_time=tr.arrival_time,
        )
        self.scheduler.add_request(req)
        self._records[rid] = RequestRecord(
            rid, tr.arrival_time, tr.prompt_len, tr.output_len
        )
        self.metrics.records.append(self._records[rid])
        return rid

    # ------------------------------------------------------------------
    def _emit(self, req: Request, t: float) -> None:
        req.out_tokens.append(0)
        rec = self._records[req.rid]
        if rec.first_token_time is None:
            rec.first_token_time = t

    def step(self) -> bool:
        """One virtual iteration; returns False when idle."""
        page = self.cfg.kv_block_size
        plan = self.scheduler.plan(
            PoolView(page, self.device.free_pages, self.host.free_pages,
                     self.device.num_pages, self.host.num_pages)
        )
        self.last_plan = plan
        if plan.is_empty():
            return False
        # recompute preemption: drop KV entirely (both pools were full)
        for r in plan.preempt:
            (self.host if r.location == "cpu" else self.device).free(r.pages)
            r.pages = []
            r.location = "gpu"
        # swaps: move page accounting between pools
        for r in plan.swap_out:
            n = len(r.pages)
            self.device.free(r.pages)
            r.pages = self.host.alloc(n)
            r.location = "cpu"
        for r in plan.swap_in:
            n = len(r.pages)
            self.host.free(r.pages)
            r.pages = self.device.alloc(n)
            r.location = "gpu"
        self.scheduler.commit(plan)

        t_end = self.clock + plan.est_iter_time + self.iter_overhead
        for r in plan.prefill:
            npages = -(-r.prefill_len // page)
            pool = self.host if r in plan.prefill_to_host else self.device
            r.pages = pool.alloc(npages)
            if not r.out_tokens:  # replayed prefills re-derive, don't re-emit
                self._emit(r, t_end)
        for r in plan.decode_rows:
            if r in plan.prefill or r.state != RequestState.RUNNING:
                continue
            if r.kv_len % page == 0 and r.kv_len // page >= len(r.pages):
                pool = self.host if r.location == "cpu" else self.device
                r.pages = r.pages + pool.alloc(1)
            self._emit(r, t_end)
            self.metrics.offloaded_decodes += int(r.location == "cpu")
            self.metrics.device_decodes += int(r.location == "gpu")

        # finishes
        for r in plan.prefill + plan.decode_rows:
            if r.state == RequestState.RUNNING and r.is_done():
                r.state = RequestState.FINISHED
                (self.host if r.location == "cpu" else self.device).free(r.pages)
                r.pages = []
                self._records[r.rid].finish_time = t_end
        self.scheduler.remove_finished()

        self.clock = t_end
        self.metrics.iterations += 1
        self.metrics.mode_counts[plan.mode] = self.metrics.mode_counts.get(plan.mode, 0) + 1
        return True


def simulate(
    cfg: ArchConfig,
    trace: List[TraceRequest],
    *,
    hw: str = "tpu_v5e",
    policy: str = "neo",
    tp: int = 1,
    max_batch_tokens: int = 8192,
    max_requests: int = 512,
    iter_overhead: float = 2e-3,
    max_iters: int = 2_000_000,
    device_pages: Optional[int] = None,
    host_pages: Optional[int] = None,
) -> ServeMetrics:
    """Run a trace through the simulator; returns ServeMetrics."""
    profile = get_profile(hw)
    if device_pages is None or host_pages is None:
        dp, hp = size_pools(cfg, profile, tp=tp)
        device_pages = device_pages if device_pages is not None else dp
        host_pages = host_pages if host_pages is not None else hp
    ecfg = EngineConfig(
        device_pool_pages=device_pages,
        host_pool_pages=host_pages,
        max_batch_tokens=max_batch_tokens,
        max_requests=max_requests,
        policy=policy,
        hw_profile=hw,
    )
    eng = SimEngine(cfg, ecfg, device_pages, host_pages, iter_overhead, tp)
    pending = sorted(trace, key=lambda t: t.arrival_time)
    i = 0
    iters = 0
    while (i < len(pending) or eng.scheduler.num_queued) and iters < max_iters:
        while i < len(pending) and pending[i].arrival_time <= eng.clock:
            eng.submit(pending[i])
            i += 1
        progressed = eng.step()
        iters += 1
        if not progressed:
            if i < len(pending):
                eng.clock = max(eng.clock, pending[i].arrival_time)
            else:
                break
    eng.metrics.makespan = eng.clock
    return eng.metrics
