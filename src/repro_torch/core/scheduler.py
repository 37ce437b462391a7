"""Load-aware scheduler — the paper's §3.2 six-step per-iteration procedure.

Queues (Fig. 2): a prefill **waitqueue**, a **GPU decoding runqueue** (device-
resident KV) and a **CPU decoding runqueue** (host-resident KV).  Each
iteration the scheduler builds BOTH a two-batch asymmetric plan and a
device-only plan and picks the higher estimated throughput (**Greedy**), while
enforcing the no-bubble inequalities

    T_ca1 <= T_l0              (batch-1 host attention hides under batch-0 linear)
    T_ca0 <= T_l1 + T_ga0      (batch-0 host attention hides under batch-1
                                linear + batch-0 device attention)

(**Balancing** / **Hiding-CPU**), and packing as much work as memory allows
(**Maximizing-GPU**).

Policies:
  * ``neo``        — the full algorithm above.
  * ``gpu_only``   — never offloads; when the device pool is full, requests
                     are preempted by swapping KV to the host (vLLM-style) and
                     only resume after swap-in.  This is the SwiftLLM baseline.
  * ``fastdecode`` — FastDecode+ (§5.3): NEO's pipelining but ALL decode
                     attention offloaded to the host; no balance constraint.
  * ``simple``     — strawman #1 (§3.1): full offload, no overlap (the perf
                     model adds stages serially instead of max-combining).

Plan annotation: after policy selection the plan is annotated with lane
splits (``_annotate_lanes``, ROADMAP PR 3/4) and a speculation depth
(``_annotate_spec``): eligibility is STRUCTURAL (decode-only greedy
plans), while the depth ``K ∈ [1, spec_k]`` is PRICED — argmax of
expected emitted tokens per second using ``PerfModel.t_verify`` and the
EWMA accept rate (see ``docs/spec_decode.md``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Iterable, List, Optional, Tuple

from repro_torch.config import ArchConfig, EngineConfig
from repro_torch.core.perfmodel import PerfModel
from repro_torch.core.request import Request, RequestState


@dataclass
class PoolView:
    """Free-page accounting snapshot handed to the scheduler."""

    page_size: int
    device_free: int
    host_free: int
    # Total pool sizes (admission control: a prompt larger than every pool can
    # never run and must be rejected instead of deadlocking the FIFO head).
    device_total: int = 1 << 30
    host_total: int = 1 << 30

    def device_take(self, n: int) -> bool:
        if n > self.device_free:
            return False
        self.device_free -= n
        return True

    def host_take(self, n: int) -> bool:
        if n > self.host_free:
            return False
        self.host_free -= n
        return True


@dataclass
class StageEstimates:
    """Per-layer stage times of the chosen plan (the paper's T_* symbols)."""

    t_l0: float = 0.0
    t_l1: float = 0.0
    t_ga0: float = 0.0
    t_ca0: float = 0.0
    t_ca1: float = 0.0
    t_swap: float = 0.0
    # host DRAM gather of host-resident cached prefixes consumed in place by
    # cpu-placed prefills (zero-copy host serving; replaces the t_swap a
    # promotion would pay and shares the host-bandwidth resource with t_ca*)
    t_host_prefix: float = 0.0
    # per-layer all-gather cost of the tensor-parallel column shards; rides
    # the device dispatch window, so it lands on the device side of every
    # overlap max.  Identically 0.0 at tp=1 — plans stay bit-identical.
    t_coll: float = 0.0
    # per-layer cost of the speculative verify chain (K+1 chained decode
    # passes over the drafting rows); priced by PerfModel.t_verify when the
    # plan drafts (spec_k > 0), identically 0.0 otherwise.
    t_verify: float = 0.0


@dataclass
class BatchPlan:
    mode: str = "asym"  # "asym" | "gpu_only" | "idle"
    # batch-0
    prefill: List[Request] = field(default_factory=list)
    prefill_to_host: List[Request] = field(default_factory=list)  # subset of prefill
    decode_gpu: List[Request] = field(default_factory=list)
    decode_cpu0: List[Request] = field(default_factory=list)
    # batch-1
    decode_cpu1: List[Request] = field(default_factory=list)
    # pool moves to perform before compute
    swap_out: List[Request] = field(default_factory=list)  # device -> host
    swap_in: List[Request] = field(default_factory=list)  # host -> device
    # recompute preemption: KV dropped entirely, request returns to the
    # waitqueue for prefill-replay (both pools were full)
    preempt: List[Request] = field(default_factory=list)
    # Unified lane plan: interior boundaries that partition ``decode_cpu1``
    # into K = len(lane_splits)+1 contiguous host lanes, e.g. [2, 5] splits
    # rows [0:2] / [2:5] / [5:].  Empty = one lane (the classic batch-1).
    # Set by :meth:`NeoScheduler._annotate_lanes` when the plan has no LONG
    # device lane (no prefill) and >= 2 host rows: batch-1-only plans split
    # FastDecode-style (the PR-3 micro-batch is the K=2 case), and mixed
    # decode-only plans BORROW the lanes so their surplus host rows overlap
    # the short device lane instead of serializing behind it.
    lane_splits: List[int] = field(default_factory=list)
    # Speculative-decoding chain depth for this iteration: each decode row
    # drafts up to ``spec_k`` tokens which the engine verifies with chained
    # passes of the unchanged fused decode graph.  Set by
    # :meth:`NeoScheduler._annotate_spec` on decode-only plans when
    # ``EngineConfig.spec_decode`` is on (structural eligibility); the perf
    # model PRICES the depth — 0 means draft nothing (plain decode).
    spec_k: int = 0
    # estimates
    est_iter_time: float = 0.0
    est_tokens: int = 0
    stages: StageEstimates = field(default_factory=StageEstimates)

    # -- derived -----------------------------------------------------------
    @property
    def batch0_tokens(self) -> int:
        # prefix-cache hits only compute (and pay linear-stage time for) the
        # uncached suffix; suffix_len == prefill_len when the cache is off
        return sum(r.suffix_len for r in self.prefill) + len(self.decode_gpu) + len(
            self.decode_cpu0
        )

    @property
    def batch1_tokens(self) -> int:
        return len(self.decode_cpu1)

    @property
    def decode_rows(self) -> List[Request]:
        return self.decode_gpu + self.decode_cpu0 + self.decode_cpu1

    @property
    def host_rows(self) -> List[Request]:
        return self.decode_cpu0 + self.decode_cpu1

    # -- lane plan ---------------------------------------------------------
    @property
    def num_host_lanes(self) -> int:
        if not self.decode_cpu1:
            return 0
        return len(self.lane_splits) + 1

    def host_lanes(self) -> List[List[Request]]:
        """``decode_cpu1`` partitioned into the plan's contiguous host lanes
        (one lane when ``lane_splits`` is empty)."""
        if not self.decode_cpu1:
            return []
        bounds = [0] + list(self.lane_splits) + [len(self.decode_cpu1)]
        return [self.decode_cpu1[a:b] for a, b in zip(bounds, bounds[1:])]

    @property
    def microbatch(self) -> bool:
        """PR-3 compatibility view: a batch-1-only plan split into >= 2
        lanes (mixed plans that merely *borrow* lanes are not micro-batched
        in the historical sense)."""
        return bool(self.lane_splits) and not (
            self.prefill or self.decode_gpu or self.decode_cpu0)

    @property
    def microbatch_split(self) -> int:
        return self.lane_splits[0] if self.microbatch else 0

    def is_empty(self) -> bool:
        return not (self.prefill or self.decode_rows or self.swap_in
                    or self.swap_out or self.preempt)

    def summary(self) -> str:
        return (
            f"mode={self.mode} prefill={len(self.prefill)}"
            f"(host={len(self.prefill_to_host)}) dec_gpu={len(self.decode_gpu)} "
            f"dec_cpu0={len(self.decode_cpu0)} dec_cpu1={len(self.decode_cpu1)} "
            f"swap_out={len(self.swap_out)} swap_in={len(self.swap_in)} "
            f"preempt={len(self.preempt)} "
            f"lanes={self.num_host_lanes} spec_k={self.spec_k} "
            f"est={self.est_iter_time * 1e3:.2f}ms/{self.est_tokens}tok"
        )


@dataclass
class SchedQueues:
    """Detached queue state the planning procedure can run against.

    Planning MUTATES queue state (admission pops the waitq, step 3 pops
    prefills, step 5 bounces them back) — parameterizing the six-step
    procedure on this view lets the engine plan SPECULATIVELY against a
    shadow copy of the queues on a planner thread while the real queues
    back the executing iteration (plan-ahead).  ``NeoScheduler`` itself is
    duck-compatible (same three attributes), so ``plan()`` with no explicit
    state runs against the live queues exactly as before.
    """

    waitq: Deque[Request] = field(default_factory=deque)
    gpu_runq: List[Request] = field(default_factory=list)
    cpu_runq: List[Request] = field(default_factory=list)


class NeoScheduler:
    def __init__(self, cfg: ArchConfig, engine_cfg: EngineConfig, perf: PerfModel):
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.perf = perf
        self.waitq: Deque[Request] = deque()
        self.gpu_runq: List[Request] = []
        self.cpu_runq: List[Request] = []
        self.policy = engine_cfg.policy
        # tracing: set by the engine when EngineConfig.tracing
        # is on.  plan() calls are globally serialized (the engine harvests
        # the planner future before planning fresh), so one "sched" track
        # never carries overlapping spans.
        self.tracer = None
        if not cfg.supports_offload and self.policy != "gpu_only":
            # NEO degrades to non-offloading mode when there is nothing to
            # offload (attention-free archs — DESIGN.md §Arch-applicability).
            self.policy = "gpu_only"

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        assert req.state == RequestState.WAITING
        self.waitq.append(req)

    def has_capacity(self) -> bool:
        """Admission control for the open-loop front end: False when the
        waitqueue is at the configured depth cap (``max_waiting``; 0 =
        unbounded).  Callers that bypass this (``NeoEngine.submit``) keep
        the closed-loop everything-is-admitted behavior."""
        mw = self.engine_cfg.max_waiting
        return mw <= 0 or len(self.waitq) < mw

    def running(self) -> List[Request]:
        return self.gpu_runq + self.cpu_runq

    # -- continuous-batching queue surface (vLLM-cacheflow naming) -------
    @property
    def waiting(self) -> List[Request]:
        """Admitted requests not yet prefilled (the arrival queue)."""
        return list(self.waitq)

    @property
    def running_rows(self) -> List[Request]:
        """Rows actively decoding this regime.  Under ``gpu_only`` the CPU
        runqueue holds swapped-OUT rows that do NOT decode until swap-in, so
        only the device queue counts as running; every other policy decodes
        host-resident rows in place."""
        if self.policy == "gpu_only":
            return list(self.gpu_runq)
        return self.gpu_runq + self.cpu_runq

    @property
    def swapped(self) -> List[Request]:
        """Rows whose KV sits on the host awaiting swap-in (vLLM-style
        SWAPPED state) — non-empty only under ``gpu_only``."""
        if self.policy == "gpu_only":
            return list(self.cpu_runq)
        return []

    def queue_depths(self) -> dict:
        return {
            "waiting": len(self.waitq),
            "running": len(self.running_rows),
            "swapped": len(self.swapped),
        }

    @property
    def num_queued(self) -> int:
        return len(self.waitq) + len(self.gpu_runq) + len(self.cpu_runq)

    def remove_finished(self) -> List[Request]:
        done = [r for r in self.gpu_runq + self.cpu_runq if r.state == RequestState.FINISHED]
        self.gpu_runq = [r for r in self.gpu_runq if r.state != RequestState.FINISHED]
        self.cpu_runq = [r for r in self.cpu_runq if r.state != RequestState.FINISHED]
        return done

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _new_pages_for_decode(self, req: Request, page_size: int) -> int:
        """Pages to allocate so the next token fits."""
        return max(0, req.pages_needed(page_size, 1) - len(req.pages))

    def _kv_tokens(self, reqs: Iterable[Request]) -> int:
        return sum(r.kv_len + 1 for r in reqs)

    def _prefill_sq(self, plan: BatchPlan) -> float:
        # Suffix prefill attends suffix x (prefix + suffix): cost scales as
        # prefill^2 - cached^2 (= prefill^2 on a cache miss / cache off).
        return float(sum(
            r.prefill_len ** 2 - (r.prefill_len - r.suffix_len) ** 2
            for r in plan.prefill
        ))

    def _t_l0(self, plan: BatchPlan, extra_tokens: int = 0) -> float:
        """Batch-0 device stage per layer: linear + prefill self-attention."""
        return self.perf.t_linear(plan.batch0_tokens + extra_tokens) + \
            self.perf.t_prefill_attn(self._prefill_sq(plan))

    # ------------------------------------------------------------------
    # the six-step procedure (§3.2)
    # ------------------------------------------------------------------
    def plan(self, pools: PoolView, state=None) -> BatchPlan:
        """Build one iteration's plan.

        ``state`` is any object with ``waitq`` / ``gpu_runq`` / ``cpu_runq``
        attributes (default: the scheduler's live queues).  Planning mutates
        that state — a :class:`SchedQueues` shadow makes the whole six-step
        procedure side-effect-free with respect to the live queues, which is
        what the engine's plan-ahead thread runs against.
        """
        tr = self.tracer
        # repro-lint: allow[no-wall-clock-in-plan] -- tracer timestamping only, guarded so plan() stays pure when tracing is off
        t0 = time.perf_counter() if tr is not None else 0.0
        st = self if state is None else state
        self._admission_control(pools, st)
        if self.policy == "gpu_only":
            plan = self._plan_gpu_only(pools, st)
        elif self.policy in ("fastdecode", "simple"):
            plan = self._plan_full_offload(pools, st)
        else:
            plan = self._plan_neo(pools, st)
        self._annotate_lanes(plan)
        self._annotate_spec(plan)
        if tr is not None:
            # repro-lint: allow[no-wall-clock-in-plan] -- closes the guarded sched/plan span; plan content never depends on the clock
            tr.emit("sched", "plan", t0, time.perf_counter(),
                    {"mode": plan.mode, "speculative": state is not None})
        return plan

    # ------------------------------------------------------------------
    # unified lane-plan annotation
    # ------------------------------------------------------------------
    def _annotate_lanes(self, plan: BatchPlan) -> None:
        """Split batch-1 into K >= 2 contiguous host lanes when nothing LONG
        hides it.

        NEO's asymmetric overlap needs a long batch-0 device lane to hide
        host attention behind.  Two plan shapes lack one:

        * **batch-1-only** (no batch-0 at all — ``fastdecode`` / full
          offload): host attention runs fully serialized (the PR-3
          micro-batch case);
        * **mixed decode-only** (batch-0 has decode rows but NO prefill —
          a structurally SHORT device lane, e.g. a swap-out burst whose
          victims decode on the host while the survivors decode on device):
          the surplus host rows in batch-1 serialize behind the short
          device dispatch.

        Both now share one mechanism: partition ``decode_cpu1`` into K
        alternating lanes so each lane's host attention overlaps the other
        lanes' linear stages (and the device lane, when present).

        Eligibility is STRUCTURAL (>= 2 host rows, no prefill — at smoke
        scale a model-gated on/off decision would never fire); the
        EWMA-calibrated perf model chooses only K and the lane boundaries,
        minimizing :meth:`PerfModel.lane_plan_time`.  Plans with prefill
        keep the single classic batch-1 lane (K=1, the PR-1 shape — the
        prefill-integrated device lane is long by construction), and
        ``lane_splits == []`` plans execute exactly as before.
        """
        plan.lane_splits = []
        cfg = self.engine_cfg
        if not (cfg.microbatch and cfg.pipeline):
            return
        if plan.mode == "serial":
            return  # strawman #1 must stay overlap-free by definition
        if plan.prefill:
            return  # long device lane: the two-batch overlap handles it
        rows = plan.decode_cpu1
        k_max = min(cfg.max_host_lanes, len(rows))
        if k_max < 2:
            return
        perf = self.perf
        # device-lane per-layer terms (0 for batch-1-only plans): compute =
        # batch-0 linear + device attention; its embedded cpu0 host attention
        # shares the host cores with the borrowed lanes.
        dev_compute = dev_attn = 0.0
        if plan.decode_gpu or plan.decode_cpu0:
            dev_compute = self._t_l0(plan) + perf.t_gpu_attn(
                self._kv_tokens(plan.decode_gpu))
            dev_attn = perf.t_cpu_attn(self._kv_tokens(plan.decode_cpu0))
        dev_coll = perf.t_collective(plan.batch0_tokens + plan.batch1_tokens)
        kv = [r.kv_len + 1 for r in rows]
        best_t, best_splits = None, None
        for k_lanes in range(2, k_max + 1):
            splits = self._lane_boundaries(kv, k_lanes, dev_compute, dev_attn,
                                           dev_coll)
            lanes = self._lane_loads(kv, splits)
            t = perf.lane_plan_time(lanes, device_compute=dev_compute,
                                    device_host_attn=dev_attn,
                                    device_collective=dev_coll)
            if best_t is None or t < best_t:
                best_t, best_splits = t, splits
        plan.lane_splits = best_splits
        plan.est_iter_time = self.cfg.num_layers * max(
            best_t, plan.stages.t_swap)

    # ------------------------------------------------------------------
    # speculative-decoding annotation
    # ------------------------------------------------------------------
    def _annotate_spec(self, plan: BatchPlan) -> None:
        """Choose the speculative chain depth K for a decode-only plan.

        Mirrors the lane-plan split: eligibility is STRUCTURAL (speculation
        on, greedy sampling, decode rows present, no prefill — a prefill
        step already saturates the device, and at smoke scale a model-gated
        on/off decision would never fire), while the perf model PRICES the
        depth.  For each K in [0, ``EngineConfig.spec_k``] the expected
        iteration emits ``rows × spec_expected_emitted(K)`` tokens in
        ``est_iter_time + L × t_verify(K)`` seconds (the verify chain is
        K+1 extra serial passes of the same decode graph, priced by the
        EWMA-calibrated :meth:`PerfModel.t_verify`); the K maximizing that
        expected throughput wins.  Like the lane split's K ∈ [2, max_host_lanes],
        the candidate set is K ∈ [1, spec_k]: once structurally eligible the
        plan always drafts and the model picks only the DEPTH (an accept-rate
        collapse drives K to 1, the cheapest probe that keeps the EWMA
        refreshed — per-row caps in the engine still shrink a row's chain
        to 0 when its token budget is exhausted).
        """
        plan.spec_k = 0
        plan.stages.t_verify = 0.0
        cfg = self.engine_cfg
        if not (cfg.spec_decode and cfg.spec_k > 0):
            return
        if cfg.decode_sample != "greedy":
            return  # verification recomputes exact greedy argmax logits
        if plan.prefill or plan.mode == "idle" or not plan.decode_rows:
            return
        perf = self.perf
        L = max(self.cfg.num_layers, 1)
        rows = plan.decode_rows
        host_kv = self._kv_tokens(plan.host_rows)
        dev_kv = self._kv_tokens(plan.decode_gpu)
        base_t = plan.est_iter_time
        if base_t <= 0.0:
            # serial/unestimated plans: price the base step as one decode pass
            base_t = L * (perf.t_linear(len(rows)) + perf.t_cpu_attn(host_kv)
                          + perf.t_gpu_attn(dev_kv))
        best_k, best_rate = 1, 0.0
        for k in range(1, cfg.spec_k + 1):
            t_v = perf.t_verify(k, n_rows=len(rows), host_kv_tokens=host_kv,
                                dev_kv_tokens=dev_kv)
            rate = len(rows) * perf.spec_expected_emitted(k) / (base_t + L * t_v)
            if rate > best_rate:
                best_k, best_rate = k, rate
        plan.spec_k = best_k
        plan.stages.t_verify = perf.t_verify(
            best_k, n_rows=len(rows), host_kv_tokens=host_kv,
            dev_kv_tokens=dev_kv)
        plan.est_iter_time = base_t + L * plan.stages.t_verify
        plan.est_tokens += int(
            len(rows) * (perf.spec_expected_emitted(best_k) - 1.0))

    @staticmethod
    def _lane_loads(kv: List[int], splits: List[int]) -> List[Tuple[int, int]]:
        """[(n_rows, kv_tokens)] per lane for boundaries ``splits``."""
        bounds = [0] + list(splits) + [len(kv)]
        return [(b - a, sum(kv[a:b])) for a, b in zip(bounds, bounds[1:])]

    def _lane_boundaries(self, kv: List[int], k_lanes: int,
                         dev_compute: float, dev_attn: float,
                         dev_coll: float = 0.0) -> List[int]:
        """Contiguous lane boundaries for ``k_lanes`` lanes over rows with
        per-row KV loads ``kv``.

        K=2 scans every split point for the exact ``lane_plan_time`` argmin
        (bit-compatible with the PR-3 micro-batch split); K>2 uses a
        balanced-KV partition via prefix sums — attention is the
        bandwidth-bound stage worth balancing (the linear term is one
        dispatch per lane regardless of where the boundaries sit).
        """
        n = len(kv)
        if k_lanes == 2:
            perf = self.perf
            total_kv = sum(kv)
            best_k, best_t = 1, None
            kv_a = 0
            for k in range(1, n):
                kv_a += kv[k - 1]
                t = perf.lane_plan_time(
                    [(k, kv_a), (n - k, total_kv - kv_a)],
                    device_compute=dev_compute, device_host_attn=dev_attn,
                    device_collective=dev_coll)
                if best_t is None or t < best_t:
                    best_k, best_t = k, t
            return [best_k]
        total = sum(kv)
        bounds: List[int] = []
        acc = 0
        for i in range(n):
            acc += kv[i]
            lanes_left = k_lanes - 1 - len(bounds)
            if lanes_left <= 0:
                break
            # place the next boundary once this lane holds its KV share, but
            # always leave >= 1 row per remaining lane
            if acc >= total * (len(bounds) + 1) / k_lanes and i + 1 <= n - lanes_left:
                bounds.append(i + 1)
        while len(bounds) < k_lanes - 1:  # force non-empty tail lanes
            prev = bounds[-1] if bounds else 0
            hi = n - (k_lanes - 1 - len(bounds) - 1)  # room for later lanes
            bounds.append(min(prev + 1, hi))
        return bounds

    def _admission_control(self, pools: PoolView, st) -> None:
        """Reject queued prompts that can never fit any pool."""
        page = pools.page_size
        cap = pools.device_total
        if self.policy in ("neo", "fastdecode", "simple"):
            cap = max(cap, pools.host_total)
        if self.policy in ("fastdecode", "simple"):
            cap = pools.host_total
        keep: Deque[Request] = deque()
        while st.waitq:
            r = st.waitq.popleft()
            pages = -(-(r.prompt_len + r.max_new_tokens) // page)
            if pages > cap or r.prompt_len > self.engine_cfg.max_batch_tokens:
                r.state = RequestState.ABORTED
            else:
                keep.append(r)
        st.waitq = keep

    # -- NEO ------------------------------------------------------------
    def _plan_neo(self, pools: PoolView, st) -> BatchPlan:
        cfg, perf = self.engine_cfg, self.perf
        page = pools.page_size
        plan = BatchPlan(mode="asym")  # step 1: initialise

        # ---- step 2: GPU decode requests -> batch-0; swap to fit ----------
        gpu_decode = sorted(st.gpu_runq, key=lambda r: r.arrival_time)
        need = sum(self._new_pages_for_decode(r, page) for r in gpu_decode)
        # shed largest-KV requests until the device pool holds all new KV:
        # swap to the host when it has room, otherwise recompute-preempt
        # (drop KV + requeue for prefill-replay) — without the fallback a
        # full host pool deadlocks the whole device batch.
        by_size = sorted(gpu_decode, key=lambda r: -r.kv_len)
        while need > pools.device_free and by_size:
            v = by_size.pop(0)
            if pools.host_take(len(v.pages) + self._new_pages_for_decode(v, page)):
                plan.swap_out.append(v)
                plan.decode_cpu1.append(v)  # decodes on the host this iteration
            else:
                plan.preempt.append(v)
            gpu_decode.remove(v)
            pools.device_free += len(v.pages)
            need -= self._new_pages_for_decode(v, page)
        pools.device_free -= sum(self._new_pages_for_decode(r, page) for r in gpu_decode)
        plan.decode_gpu = gpu_decode

        # swap IN when there is ample device space (Maximizing GPU)
        for r in sorted(st.cpu_runq, key=lambda r: r.kv_len):
            pages = len(r.pages) + self._new_pages_for_decode(r, page)
            headroom = pools.device_free - pages
            if headroom < int(0.25 * pools.device_free):
                break
            pools.device_free -= pages
            plan.swap_in.append(r)
            plan.decode_gpu.append(r)

        # ---- step 3: prefill requests -> batch-0 (Maximizing GPU) ---------
        # Zero-copy host serving: a request whose longest cached prefix is
        # HOST-resident is placed on the cpu queue first, so acquire() pins
        # the prefix in place (no promotion PCIe) and host attention serves
        # it straight from DRAM.  The preference is STRUCTURAL (residency of
        # the submit-time match), not model-gated — at smoke scale a
        # perf-model on/off decision would never fire; the model only prices
        # the resulting plan (t_host_prefix vs the promote-path t_swap).
        host_serve = cfg.prefix_host_serving
        budget = cfg.max_batch_tokens - plan.batch0_tokens
        while st.waitq and len(plan.prefill) + len(plan.decode_rows) < cfg.max_requests:
            nxt = st.waitq[0]
            if nxt.suffix_len > budget:
                break
            pages = nxt.new_prefill_pages(page)  # cached full pages are shared
            # one-shot preference: a request the step-5 balancer bounced back
            # (skipped > 0) falls through to the historical device-first
            # order — otherwise a hot CPU queue could place-then-drop the
            # same host-preferred prefill forever, head-of-line-blocking the
            # FIFO while HBM sits free
            prefer_host = (host_serve and nxt.cached_len > 0
                           and nxt.prefix_loc == "cpu" and nxt.skipped == 0)
            if prefer_host and pools.host_take(pages):
                req = st.waitq.popleft()
                plan.prefill.append(req)
                plan.prefill_to_host.append(req)
            elif pools.device_take(pages):
                plan.prefill.append(st.waitq.popleft())
            elif pools.host_take(pages):
                req = st.waitq.popleft()
                plan.prefill.append(req)
                plan.prefill_to_host.append(req)
            else:
                break
            budget -= nxt.suffix_len

        # ---- step 4: CPU decode requests -> batch-0 / batch-1 -------------
        in_plan = set(id(r) for r in plan.swap_in)
        t_ga0 = perf.t_gpu_attn(self._kv_tokens(plan.decode_gpu))
        cpu_candidates = [r for r in st.cpu_runq if id(r) not in in_plan]
        # swap-out victims already decode on the host in batch-1
        kv0 = 0  # host kv tokens in batch-0
        kv1 = self._kv_tokens(plan.swap_out)  # host kv tokens in batch-1
        # FIFO scan (paper: "scan the CPU decoding runqueue") — skipped
        # requests retry next iteration, so no request starves.
        starve = self.engine_cfg.starvation_limit
        # Fill order (refinement over the paper, recorded in EXPERIMENTS §Perf):
        # batch-1's linear stage re-reads every layer's weights even for one
        # row, so batch-1 only pays when batch-0's device stage is LONG
        # (prefill integrated).  Decode-only iterations fill batch-0's CPU
        # share first — those rows hide under the device attention t_ga0 at
        # zero extra weight traffic.
        prefer_b1 = bool(plan.prefill)
        for r in sorted(cpu_candidates, key=lambda r: r.arrival_time):
            if self._new_pages_for_decode(r, page) > 0 and not pools.host_take(
                self._new_pages_for_decode(r, page)
            ):
                # host pool exhausted: a stuck host row pins dozens of pages —
                # after the starvation limit, recompute-preempt it so the pool
                # drains instead of deadlocking
                r.skipped += 1
                if r.skipped >= starve:
                    plan.preempt.append(r)
                    pools.host_free += len(r.pages)
                    r.skipped = 0
                continue
            # a request skipped `starvation_limit` times in a row is forced in
            # — without this a mis-calibrated perf model can park host
            # requests forever while they pin host pages (queue deadlock).
            t_l1_next = perf.t_linear(plan.batch1_tokens + 1)
            fits_b1 = perf.t_cpu_attn(kv1 + r.kv_len + 1) <= self._t_l0(plan, 1)
            fits_b0 = perf.t_cpu_attn(kv0 + r.kv_len + 1) <= t_l1_next + t_ga0
            if prefer_b1 and (fits_b1 or r.skipped >= starve):
                plan.decode_cpu1.append(r)
                kv1 += r.kv_len + 1
                r.skipped = 0
            elif fits_b0:
                plan.decode_cpu0.append(r)
                kv0 += r.kv_len + 1
                r.skipped = 0
            elif fits_b1 or r.skipped >= starve:
                plan.decode_cpu1.append(r)
                kv1 += r.kv_len + 1
                r.skipped = 0
            else:
                # would violate both inequalities: retry next iteration
                r.skipped += 1
                if self._new_pages_for_decode(r, page) > 0:
                    pools.host_free += self._new_pages_for_decode(r, page)

        # ---- step 5: reduce prefill (drop host-destined prefills) ---------
        # A host-destined prefill costs swap-out PCIe time and feeds the CPU
        # queue.  Drop it ONLY when the CPU already has more queued attention
        # work than one iteration can hide (otherwise the CPU would go idle in
        # future iterations — "Balancing"), and only while the no-bubble
        # inequality T_ca1 <= T_l0 still holds after the removal.
        cpu_demand = perf.t_cpu_attn(
            self._kv_tokens(st.cpu_runq) + sum(r.prompt_len for r in plan.prefill_to_host)
        )
        for req in list(plan.prefill_to_host):
            hideable = self._t_l0(plan) + perf.t_linear(plan.batch1_tokens) + t_ga0
            if cpu_demand <= hideable:
                break  # CPU underfed: keep feeding it host-destined prefills
            without = self._t_l0(plan) - (
                perf.t_linear(plan.batch0_tokens)
                - perf.t_linear(plan.batch0_tokens - req.suffix_len)
            ) - perf.t_prefill_attn(
                req.prefill_len ** 2 - (req.prefill_len - req.suffix_len) ** 2
            )
            if perf.t_cpu_attn(kv1) <= without:
                plan.prefill.remove(req)
                plan.prefill_to_host.remove(req)
                req.skipped += 1  # disarms the host-placement preference
                st.waitq.appendleft(req)
                pools.host_free += req.new_prefill_pages(page)
                cpu_demand -= perf.t_cpu_attn(req.prompt_len)

        # ---- step 6: greedy decision vs the device-only plan --------------
        self._estimate(plan)
        gpu_plan = self._gpu_only_variant(plan)
        if gpu_plan is not None and self._throughput(gpu_plan) > self._throughput(plan):
            return gpu_plan
        return plan

    def _gpu_only_variant(self, plan: BatchPlan) -> Optional[BatchPlan]:
        """Step 6 (paper): "taking batch-0 and excluding all the CPU decoding
        requests added in step 4" — prefills (including host-destined ones)
        stay in BOTH candidate plans, so the greedy comparison isolates the
        marginal tokens-per-time of the offloaded decode rows."""
        step4_cpu0 = plan.decode_cpu0
        step4_cpu1 = [r for r in plan.decode_cpu1 if r not in plan.swap_out]
        if step4_cpu0 or step4_cpu1:
            g = BatchPlan(
                mode="gpu_only",
                prefill=list(plan.prefill),
                prefill_to_host=list(plan.prefill_to_host),
                decode_gpu=list(plan.decode_gpu),
                swap_out=list(plan.swap_out),
                swap_in=list(plan.swap_in),
                preempt=list(plan.preempt),
                # swap-out victims still decode (on host): their KV already
                # left the device this iteration.
                decode_cpu1=list(plan.swap_out),
            )
            self._estimate(g)
            return g
        return None

    # -- baselines -------------------------------------------------------
    def _plan_gpu_only(self, pools: PoolView, st) -> BatchPlan:
        page = pools.page_size
        plan = BatchPlan(mode="gpu_only")
        gpu_decode = sorted(st.gpu_runq, key=lambda r: r.arrival_time)
        need = sum(self._new_pages_for_decode(r, page) for r in gpu_decode)
        by_size = sorted(gpu_decode, key=lambda r: -r.kv_len)
        while need > pools.device_free and by_size:
            v = by_size.pop(0)
            if pools.host_take(len(v.pages)):
                plan.swap_out.append(v)  # swapped: does NOT decode this iter
            else:
                plan.preempt.append(v)  # host full too: recompute-preempt
            gpu_decode.remove(v)
            pools.device_free += len(v.pages)
            need -= self._new_pages_for_decode(v, page)
        pools.device_free -= sum(self._new_pages_for_decode(r, page) for r in gpu_decode)
        plan.decode_gpu = gpu_decode
        # swap preempted requests back in when space allows
        for r in sorted(st.cpu_runq, key=lambda r: r.kv_len):
            pages = len(r.pages) + self._new_pages_for_decode(r, page)
            if pools.device_free - pages < 0:
                break
            pools.device_free -= pages
            plan.swap_in.append(r)
            plan.decode_gpu.append(r)
        budget = self.engine_cfg.max_batch_tokens - plan.batch0_tokens
        while st.waitq and len(plan.prefill) + len(plan.decode_rows) < self.engine_cfg.max_requests:
            nxt = st.waitq[0]
            pages = nxt.new_prefill_pages(page)
            if nxt.suffix_len > budget or not pools.device_take(pages):
                break
            plan.prefill.append(st.waitq.popleft())
            budget -= nxt.suffix_len
        self._estimate(plan)
        return plan

    def _plan_full_offload(self, pools: PoolView, st) -> BatchPlan:
        """FastDecode+ / simple-offloading: ALL decode KV lives on the host."""
        page = pools.page_size
        mode = "asym" if self.policy == "fastdecode" else "serial"
        plan = BatchPlan(mode=mode)
        # every running request is (or becomes) a host request
        for r in list(st.gpu_runq):
            if pools.host_take(len(r.pages) + self._new_pages_for_decode(r, page)):
                plan.swap_out.append(r)
                plan.decode_cpu1.append(r)
        starve = self.engine_cfg.starvation_limit
        for r in st.cpu_runq:
            if self._new_pages_for_decode(r, page) and not pools.host_take(
                self._new_pages_for_decode(r, page)
            ):
                r.skipped += 1
                if r.skipped >= starve:
                    plan.preempt.append(r)
                    pools.host_free += len(r.pages)
                    r.skipped = 0
                continue
            r.skipped = 0
            plan.decode_cpu1.append(r)
        budget = self.engine_cfg.max_batch_tokens
        while st.waitq and len(plan.prefill) + len(plan.decode_rows) < self.engine_cfg.max_requests:
            nxt = st.waitq[0]
            pages = nxt.new_prefill_pages(page)
            if nxt.suffix_len > budget or not pools.host_take(pages):
                break
            req = st.waitq.popleft()
            plan.prefill.append(req)
            plan.prefill_to_host.append(req)
            budget -= nxt.suffix_len  # match the admission check (replayed
            # prefills cover prompt + all-but-one emitted token)
        self._estimate(plan)
        return plan

    # -- estimation -------------------------------------------------------
    def _estimate(self, plan: BatchPlan) -> None:
        perf = self.perf
        # Prefix-hit pricing (residency from the submit-time match estimate):
        # a cpu-placed prefill whose prefix is host-resident gathers it in
        # place at host DRAM bandwidth (t_host_prefix); a gpu-placed prefill
        # whose prefix is host-resident must PROMOTE it over PCIe first, so
        # those tokens are priced into t_swap.
        to_host = set(id(r) for r in plan.prefill_to_host)
        host_gather = sum(r.cached_len for r in plan.prefill_to_host
                          if r.prefix_loc == "cpu")
        promote_tokens = sum(r.cached_len for r in plan.prefill
                             if id(r) not in to_host and r.prefix_loc == "cpu")
        st = StageEstimates(
            t_l0=self._t_l0(plan),
            t_l1=perf.t_linear(plan.batch1_tokens),
            t_ga0=perf.t_gpu_attn(self._kv_tokens(plan.decode_gpu)),
            t_ca0=perf.t_cpu_attn(self._kv_tokens(plan.decode_cpu0)),
            t_ca1=perf.t_cpu_attn(self._kv_tokens(plan.decode_cpu1))
            ,
            t_swap=perf.t_swap(
                sum(r.kv_len for r in plan.swap_out)
                + sum(r.kv_len for r in plan.swap_in)
                # host-destined prefills only push the freshly computed
                # suffix KV over PCIe; cached prefix pages are shared in place
                + sum(r.suffix_len for r in plan.prefill_to_host)
                + promote_tokens
            ),
            t_host_prefix=perf.t_host_prefix(host_gather),
            t_coll=perf.t_collective(plan.batch0_tokens + plan.batch1_tokens),
        )
        plan.stages = st
        L = self.cfg.num_layers
        if plan.mode == "serial":  # strawman #1: no overlap
            plan.est_iter_time = L * (st.t_l0 + st.t_l1 + st.t_ga0 + st.t_ca0
                                      + st.t_ca1 + st.t_swap + st.t_host_prefix
                                      + st.t_coll)
        elif plan.mode == "gpu_only" and not plan.decode_cpu1:
            plan.est_iter_time = perf.gpu_only_time(
                batch_tokens=plan.batch0_tokens,
                gpu_kv_tokens=self._kv_tokens(plan.decode_gpu),
                prefill_sq_sum=self._prefill_sq(plan),
            ) + L * st.t_coll
        else:
            # t_host_prefix shares the host-DRAM-bandwidth resource with the
            # batch-0 CPU attention, so it lands on that side of the max;
            # the TP all-gather rides the device dispatch lane (t_l0 side)
            plan.est_iter_time = L * (
                max(st.t_l0 + st.t_coll, st.t_ca1)
                + max(st.t_l1 + st.t_ga0, st.t_ca0 + st.t_host_prefix, st.t_swap)
            )
        plan.est_tokens = len(plan.decode_rows) + len(plan.prefill)

    @staticmethod
    def _throughput(plan: BatchPlan) -> float:
        if plan.est_iter_time <= 0:
            return 0.0
        return plan.est_tokens / plan.est_iter_time

    # ------------------------------------------------------------------
    # post-iteration bookkeeping
    # ------------------------------------------------------------------
    def commit(self, plan: BatchPlan) -> None:
        """Apply queue moves implied by the plan (engine calls after swaps)."""
        for r in plan.preempt:
            if r in self.gpu_runq:
                self.gpu_runq.remove(r)
            if r in self.cpu_runq:
                self.cpu_runq.remove(r)
            r.state = RequestState.WAITING
            self.waitq.appendleft(r)
        for r in plan.swap_out:
            if r in self.gpu_runq:
                self.gpu_runq.remove(r)
            if r not in self.cpu_runq:
                self.cpu_runq.append(r)
        for r in plan.swap_in:
            if r in self.cpu_runq:
                self.cpu_runq.remove(r)
            if r not in self.gpu_runq:
                self.gpu_runq.append(r)
        for r in plan.prefill:
            r.state = RequestState.RUNNING
            r.skipped = 0  # step-5 bounce marks don't leak into decode aging
            if r in plan.prefill_to_host:
                r.location = "cpu"
                self.cpu_runq.append(r)
            else:
                r.location = "gpu"
                self.gpu_runq.append(r)
