"""NeoEngine — the online serving engine (continuous batching + NEO offload),
serial path.

The engine is paged or contiguous as the reference decides
(``cfg.family in PAGED_FAMILIES and cfg.supports_offload``).  On the paged
path (dense family) one :meth:`NeoEngine.step` is one inference iteration:

* **plan** — the load-aware scheduler builds the two-batch asymmetric plan
  (which decode rows attend on the device, which on the host; swaps;
  preemptions; prefills);
* **launch** — recompute preemptions drop KV, swaps copy whole requests
  between the pools inline (:meth:`DualPool.swap_request`), queue moves
  commit, and pages are allocated for prefills and growing decode rows;
* **execute** — the prefill sub-batch, then one decode pass over all rows
  (:meth:`PagedExecutor.decode`: device rows through the paged decode
  kernel, host rows through host attention), and greedy sampling in plan
  order.

On the contiguous path (ssm and hybrid families, device-only) the scheduler
sees one "page" per slot of :class:`ContiguousExecutor`; a step prefills its
new requests one at a time into free slots, then runs one decode over all
slots in which only the running rows' slots advance.

This is the reference engine's ``pipeline=False`` path.  Its pipelined
execution (async swaps, concurrent host lanes, plan-ahead) is ROADMAP P7;
tensor parallelism P13, the prefix cache P9, speculative decoding P10 and
tracing P8.  Building the engine with any of those switched on raises
``NotImplementedError`` rather than running the serial path in its place.

Fault tolerance: every accepted request is journaled (prompt + sampling
params + emitted tokens); :meth:`export_journal` / :meth:`replay_journal`
implement prefill-replay recovery.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ArchConfig, EngineConfig
from repro_torch.core.executor import ContiguousExecutor, PagedExecutor
from repro_torch.core.host_attention import HostAttention
from repro_torch.core.kv_cache import DualPool
from repro_torch.core.perfmodel import PerfModel
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import BatchPlan, NeoScheduler, PoolView
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model

PAGED_FAMILIES = ("dense", "moe", "vlm")


@dataclass
class EngineStats:
    """The reference's ``EngineStats`` counters that the serial path updates
    (the pipelining, lane, plan-ahead and speculation counters arrive with
    those features)."""

    iterations: int = 0
    tokens_out: int = 0
    prefill_tokens: int = 0
    mode_counts: Dict[str, int] = field(default_factory=dict)
    offloaded_decodes: int = 0
    device_decodes: int = 0
    wall_time: float = 0.0
    host_busy_time: float = 0.0
    # prefill + decode dispatch wall time (host attention runs inside it)
    device_busy_time: float = 0.0
    # per-lane dispatch wall time: "prefill" and "serial" (the decode pass)
    lane_busy_time: Dict[str, float] = field(default_factory=dict)
    plan_busy_time: float = 0.0
    # open-loop admission control: arrivals bounced by offer()
    rejected_requests: int = 0
    plans: List[str] = field(default_factory=list)

    def record_plan(self, plan: BatchPlan) -> None:
        self.mode_counts[plan.mode] = self.mode_counts.get(plan.mode, 0) + 1
        if len(self.plans) < 1000:
            self.plans.append(plan.summary())

    def lane_add(self, lane: str, dt: float) -> None:
        self.lane_busy_time[lane] = self.lane_busy_time.get(lane, 0.0) + dt


def _unsupported(engine_cfg: EngineConfig) -> Optional[str]:
    if engine_cfg.pipeline:
        return ("pipelined execution is not ported yet (ROADMAP P7); "
                "build the engine with pipeline=False")
    if engine_cfg.tp > 1:
        return "tensor-parallel serving is not ported yet (ROADMAP P13)"
    if engine_cfg.prefix_cache:
        return "the prefix cache is not ported yet (ROADMAP P9)"
    if engine_cfg.spec_decode:
        return "speculative decoding is not ported yet (ROADMAP P10)"
    if engine_cfg.tracing:
        return "engine tracing is not ported yet (ROADMAP P8)"
    return None


class NeoEngine:
    """The NEO serving engine on the card (``device="cpu"`` for the CPU).

    ``params`` is a state dict of the port's model (for example
    :func:`repro_torch.models.bridge.params_from_reference` of a reference
    tree); without it the weights are random, from a ``torch.Generator``
    seeded with ``engine_cfg.seed``.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        engine_cfg: EngineConfig = EngineConfig(),
        *,
        params: Optional[Mapping[str, Any]] = None,
        device=None,
    ):
        why = _unsupported(engine_cfg)
        if why is not None:
            raise NotImplementedError(why)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.model = get_model(cfg, device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(engine_cfg.seed)
            self.model.init(gen)
        else:
            self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()},
                                       strict=True)
        self.perf = PerfModel.for_arch(cfg, engine_cfg.hw_profile, engine_cfg.ewma_alpha)
        self.scheduler = NeoScheduler(cfg, engine_cfg, self.perf)
        self.paged = cfg.family in PAGED_FAMILIES and cfg.supports_offload
        if self.paged:
            self.pool = DualPool(cfg, engine_cfg.device_pool_pages,
                                 engine_cfg.host_pool_pages, device=self.device)
            # page 0 stays reserved, as in the reference (its decode scratch
            # page), so both engines see the same device page budget
            self._scratch = self.pool.device.alloc(1)
            self.host_attn = HostAttention(cfg, self.pool.host.k.numpy(),
                                           self.pool.host.v.numpy(),
                                           threads=engine_cfg.host_threads)
            self.executor = PagedExecutor(self.model, self.pool, self.host_attn)
            self._page = cfg.kv_block_size
        else:
            self.executor = ContiguousExecutor(
                self.model, slots=min(engine_cfg.max_requests, 64),
                capacity=engine_cfg.max_batch_tokens)
            self._page = self.executor.capacity  # 1 "page" == 1 slot for the scheduler
            self.pool = None
            self.host_attn = None
        self._rng = np.random.default_rng(engine_cfg.seed)
        self._next_rid = 0
        self.requests: Dict[int, Request] = {}
        self.stats = EngineStats()
        self._journal: List[Dict[str, Any]] = []
        self.clock = 0.0  # virtual clock (arrival bookkeeping in offline runs)

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        arrival_time: Optional[float] = None,
        eos_token: Optional[int] = None,
    ) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(
            rid=rid,
            prompt=list(map(int, prompt)),
            max_new_tokens=int(max_new_tokens),
            arrival_time=self.clock if arrival_time is None else arrival_time,
            eos_token=eos_token,
        )
        self.requests[rid] = req
        self.scheduler.add_request(req)
        self._journal.append(
            {
                "rid": rid,
                "prompt": list(req.prompt),
                "max_new_tokens": req.max_new_tokens,
                "arrival_time": req.arrival_time,
                "eos_token": eos_token,
                "out_tokens": req.out_tokens,  # aliased: auto-updates
            }
        )
        return rid

    def offer(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        arrival_time: Optional[float] = None,
        eos_token: Optional[int] = None,
    ) -> Optional[int]:
        """Admission-controlled :meth:`submit`: returns ``None`` (and counts
        the rejection) when the waitqueue is at ``max_waiting`` depth."""
        if not self.scheduler.has_capacity():
            self.stats.rejected_requests += 1
            return None
        return self.submit(prompt, max_new_tokens, arrival_time=arrival_time,
                           eos_token=eos_token)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _pool_view(self) -> PoolView:
        if self.paged:
            return PoolView(
                page_size=self._page,
                device_free=self.pool.device.free_pages,
                host_free=self.pool.host.free_pages,
                device_total=self.pool.device.num_pages - 1,  # minus scratch
                host_total=self.pool.host.num_pages,
            )
        return PoolView(
            page_size=self._page,
            device_free=len(self.executor.free_slots),
            host_free=0,
            device_total=self.executor.slots,
            host_total=0,
        )

    def _sample(self, logits: np.ndarray) -> int:
        if self.engine_cfg.decode_sample == "greedy":
            return int(np.argmax(logits))
        z = logits.astype(np.float64)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def _emit(self, req: Request, logits: np.ndarray, now: float,
              emitted: List[Tuple[int, int]]) -> None:
        tok = self._sample(logits)
        req.out_tokens.append(tok)
        if req.first_token_time is None:
            req.first_token_time = now
        emitted.append((req.rid, tok))
        self.stats.tokens_out += 1

    def _finish(self, req: Request, now: float) -> None:
        req.state = RequestState.FINISHED
        req.finish_time = now
        if req.pages:
            if self.paged:
                self.pool.pool(req.location).free(req.pages)
            else:
                self.executor.free_slot(req.pages[0])
        req.pages = []

    # ------------------------------------------------------------------
    # one iteration
    # ------------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> List[Tuple[int, int]]:
        """Run one inference iteration; returns [(rid, new_token), ...]."""
        t0 = time.perf_counter()
        now = self.clock if now is None else now
        self.clock = now
        host_busy0 = self.host_attn.busy_time if self.paged else 0.0
        dev_busy0 = self.stats.device_busy_time

        p0 = time.perf_counter()
        plan = self.scheduler.plan(self._pool_view())
        self.stats.plan_busy_time += time.perf_counter() - p0
        if plan.is_empty():
            return []
        self.stats.iterations += 1
        self.stats.record_plan(plan)

        emitted: List[Tuple[int, int]] = []
        if self.paged:
            self._step_paged(plan, now, emitted)
        else:
            self._step_contiguous(plan, now, emitted)

        for req in plan.prefill + plan.decode_rows:
            if req.state == RequestState.RUNNING and req.is_done():
                self._finish(req, now)
        self.scheduler.remove_finished()

        self.stats.wall_time += time.perf_counter() - t0
        if self.paged:
            # perf-model refresh from measured stage times (EWMA); the
            # reference refreshes it on the paged path only
            host_busy = self.host_attn.busy_time - host_busy0
            self.stats.host_busy_time += host_busy
            self.perf.observe_iteration(
                plan.stages,
                host_busy=host_busy,
                device_busy=self.stats.device_busy_time - dev_busy0,
                pipelined=False,
            )
        return emitted

    def _step_paged(self, plan: BatchPlan, now: float,
                    emitted: List[Tuple[int, int]]) -> None:
        # ==== LAUNCH =========================================================
        # recompute preemption (both pools full): drop KV, requeue
        for r in plan.preempt:
            self.pool.pool(r.location).free(r.pages)
            r.pages = []
            r.location = "gpu"
            r.cached_len = 0
            r.prefix_loc = None
        for r in plan.swap_out:
            self.pool.swap_request(r, "cpu")
        for r in plan.swap_in:
            self.pool.swap_request(r, "gpu")
        self.scheduler.commit(plan)

        # Page allocation in the reference's order: prefill pages, then
        # decode-row pages in gpu/cpu0/cpu1 plan order.  Replayed prefills
        # (recompute preemption) re-derive their last token and do not emit.
        page = self._page

        def _running(rs: List[Request]) -> List[Request]:
            return [r for r in rs
                    if r.state == RequestState.RUNNING and r not in plan.prefill]

        rows = (_running(plan.decode_gpu) + _running(plan.decode_cpu0)
                + _running(plan.decode_cpu1))
        to_host: List[bool] = []
        for r in plan.prefill:
            host = r in plan.prefill_to_host
            r.cached_len = 0
            r.pages = self.pool.pool("cpu" if host else "gpu").alloc(-(-r.prefill_len // page))
            to_host.append(host)
        host_flags: List[bool] = []
        for r in rows:
            host = r.location == "cpu"
            if r.kv_len % page == 0 and r.kv_len // page >= len(r.pages):
                r.pages = r.pages + self.pool.pool(r.location).alloc(1)
            host_flags.append(host)

        # ==== EXECUTE ========================================================
        if plan.prefill:
            t0 = time.perf_counter()
            logits = self.executor.prefill(plan.prefill, to_host)
            dt = time.perf_counter() - t0
            self.stats.device_busy_time += dt
            self.stats.lane_add("prefill", dt)
            self.stats.prefill_tokens += sum(r.suffix_len for r in plan.prefill)
            for i, r in enumerate(plan.prefill):
                if not r.out_tokens:
                    self._emit(r, logits[i], now, emitted)
        if rows:
            t0 = time.perf_counter()
            logits = self.executor.decode(rows, host_flags)
            dt = time.perf_counter() - t0
            self.stats.device_busy_time += dt
            self.stats.lane_add("serial", dt)
            self.stats.offloaded_decodes += sum(host_flags)
            self.stats.device_decodes += len(rows) - sum(host_flags)
            for i, r in enumerate(rows):
                self._emit(r, logits[i], now, emitted)

    def _step_contiguous(self, plan: BatchPlan, now: float,
                         emitted: List[Tuple[int, int]]) -> None:
        self.scheduler.commit(plan)
        t0 = time.perf_counter()
        for r in plan.prefill:
            slot = self.executor.alloc_slot()
            r.pages = [slot]
            logits = self.executor.prefill(r, slot)
            self.stats.prefill_tokens += r.prompt_len
            self._emit(r, logits, now, emitted)
        if plan.prefill:
            dt = time.perf_counter() - t0
            self.stats.device_busy_time += dt
            self.stats.lane_add("prefill", dt)
        rows = [r for r in plan.decode_rows if r.state == RequestState.RUNNING
                and r not in plan.prefill]
        if rows:
            t0 = time.perf_counter()
            tokens_by_slot = np.zeros((self.executor.slots,), np.int64)
            active = np.zeros((self.executor.slots,), bool)
            for r in rows:
                tokens_by_slot[r.pages[0]] = r.all_tokens[-1]
                active[r.pages[0]] = True
            logits = self.executor.decode(tokens_by_slot, active)
            dt = time.perf_counter() - t0
            self.stats.device_busy_time += dt
            self.stats.lane_add("serial", dt)
            self.stats.device_decodes += len(rows)
            for r in rows:
                self._emit(r, logits[r.pages[0]], now, emitted)

    # ------------------------------------------------------------------
    # lifecycle and drivers
    # ------------------------------------------------------------------
    def close(self) -> None:
        """Stop the host-attention worker threads (idempotent; a contiguous
        engine has none)."""
        if self.host_attn is not None:
            self.host_attn.close()

    def run_until_done(self, max_iters: int = 10_000) -> Dict[int, List[int]]:
        """Drain all queued work; returns {rid: out_tokens}."""
        it = 0
        while self.scheduler.num_queued > 0 and it < max_iters:
            self.step(now=self.clock + 1e-3)
            it += 1
        return {rid: list(r.out_tokens) for rid, r in self.requests.items()}

    # ------------------------------------------------------------------
    # fault tolerance: journal + prefill-replay recovery
    # ------------------------------------------------------------------
    def export_journal(self) -> List[Dict[str, Any]]:
        out = []
        for e in self._journal:
            req = self.requests[e["rid"]]
            out.append(
                {
                    **{k: v for k, v in e.items() if k != "out_tokens"},
                    "out_tokens": list(req.out_tokens),
                    "finished": req.state in (RequestState.FINISHED, RequestState.ABORTED),
                }
            )
        return out

    def replay_journal(self, journal: List[Dict[str, Any]]) -> Dict[int, int]:
        """Resume unfinished journaled requests on THIS engine (prefill-replay).

        Returns {old_rid: new_rid}.  Emitted tokens are preserved by extending
        the replay prompt; generation continues from the exact next position.
        """
        mapping: Dict[int, int] = {}
        for e in journal:
            if e.get("finished"):
                continue
            done = len(e["out_tokens"])
            if done >= e["max_new_tokens"]:
                continue
            new_rid = self.submit(
                list(e["prompt"]) + list(e["out_tokens"]),
                e["max_new_tokens"] - done,
                arrival_time=e.get("arrival_time", 0.0),
                eos_token=e.get("eos_token"),
            )
            mapping[e["rid"]] = new_rid
        return mapping
