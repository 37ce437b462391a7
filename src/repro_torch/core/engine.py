"""NeoEngine — the online serving engine (continuous batching + NEO offload).

The engine is paged or contiguous as the reference decides
(``cfg.family in PAGED_FAMILIES and cfg.supports_offload``).  On the paged
path (dense, moe and vlm families) one :meth:`NeoEngine.step` is one
inference iteration in explicit **plan → launch → join** phases:

* **plan** — the load-aware scheduler builds the two-batch asymmetric plan
  (which decode rows attend on the device, which on the host; swaps;
  preemptions; prefills), or adopts the plan a planner thread built for it
  while the previous iteration ran (plan-ahead);
* **launch** — recompute preemptions drop KV, swaps start on the
  :class:`TransferEngine`'s copy streams (page accounting moves now),
  queue moves commit, the next plan-ahead starts, and pages are allocated
  for prefills and growing decode rows;
* **join** — the plan executes as a **unified lane plan**: one optional
  device lane (the prefill sub-batch, then batch-0's decode pass, on the
  engine thread and its own CUDA stream) plus K >= 0 host lanes (host-only
  decode passes on the executor's lane threads, each on its own stream),
  where the scheduler's ``lane_splits`` partition batch-1.  Swap-outs join
  lane-scoped on the lane that decodes them, right before its host attention
  reads the pages; swap-ins join on the engine thread before batch-0 reads
  the pool; everything else joins at the end-of-step :meth:`drain`.  Logits
  join and tokens are sampled in plan order, so greedy decode emits the
  serial path's tokens.

With ``pipeline=False`` (or a "serial"-mode plan) swaps copy inline
(:meth:`DualPool.swap_request`) and one decode pass covers all rows.  Every
device-lane window ends at a synchronising copy of its logits to the host,
so the overlap counters of :class:`EngineStats` measure work, not launches.

On the contiguous path (ssm, hybrid and audio families, device-only) the
scheduler sees one "page" per slot of :class:`ContiguousExecutor`; a step
prefills its new requests one at a time into free slots, then runs one
decode over all slots in which only the running rows' slots advance.
``pipeline`` does not apply there, as in the reference.

A request's ``extras`` (``submit``/``offer``) are its model inputs beside
the tokens, as in the reference: a vlm's ``patch_embeds``, stacked over a
paged prefill batch by :meth:`NeoEngine._extras_batch`, and an
encoder-decoder's ``frames``, handed to its contiguous prefill.  A request
with extras is never prefix-cached, and a recompute replay prefills with
them again.

Tracing (``EngineConfig.tracing``, :mod:`repro_torch.obs`) is off by
default.  When on, every emit site sits behind ``if tracer is not None``, so
the traced and untraced paths run the same computation, and every span
carries the very floats the stats consumed, so ``obs.reconcile`` recomputes
the overlap accounting from the spans.  The contiguous path emits
``device``/``prefill`` and ``device``/``serial`` spans for the lane windows
it records (the reference's contiguous path records none).

The two-tier radix prefix cache (``EngineConfig.prefix_cache``,
:mod:`repro_torch.core.prefix_cache`) is the reference's: a request's prompt
is matched at submit (the scheduler prices its suffix and prefers the host
when the prefix lives there), pinned at prefill dispatch (shared pages by
refcount, a copy-on-write page for a match that ends mid-page, deferral when
the match shrank past the token or page budget), and a finished request's
pages go into the tree, which reclaims room by demoting device pages to the
host before dropping any.  With the cache on, decode rows grow their pages
before the prefills take theirs; with it off, after, as in the reference.

Speculative decoding (``EngineConfig.spec_decode``, :mod:`repro_torch.core.spec`)
is the reference's: after a decode step's base emission, each drafting row
expands into pseudo-rows at successive KV positions over its own pages, and
ONE extra batched pass of the unchanged decode path verifies every draft
position at once (:meth:`NeoEngine._run_spec_chain`); the accept walk
emits only what serial greedy decode would have, and rollback frees only
pages the chain grew.  Verify wall time goes to
``EngineStats.spec_busy_time`` and the unaudited ``spec`` span track, never
to the lane busy times ``reconcile()`` audits.

Tensor parallelism (``EngineConfig.tp``, gather-TP,
:mod:`repro_torch.distributed.sharding`) is the reference's single
controller: one engine thread drives ``tp`` shards, each on a device of
``shard_devices`` (:func:`repro_torch.launch.mesh.shard_devices`: by
default ``cuda:0`` .. ``cuda:tp-1``, ``tp`` x ``cpu`` for a CPU engine; an
explicit list may name one device more than once).  The device pool shards
by KV head, each shard's host attention runs over its KV-head view of the
one host pool, and swaps fan out into per-shard copy streams; the scheduler
above sees one engine.  It serves the dense family on the paged engine
only, as the reference does; greedy tokens are those of ``tp=1``.

Fault tolerance: every accepted request is journaled (prompt + sampling
params + emitted tokens); :meth:`export_journal` / :meth:`replay_journal`
implement prefill-replay recovery.
"""

from __future__ import annotations

import copy
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ArchConfig, EngineConfig
from repro_torch.core.executor import ContiguousExecutor, PagedExecutor
from repro_torch.core.host_attention import HostAttention
from repro_torch.core.kv_cache import DualPool
from repro_torch.core.perfmodel import PerfModel
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import BatchPlan, NeoScheduler, PoolView, SchedQueues
from repro_torch.core.spec import NgramDrafter
from repro_torch.core.transfer import WAIT_TIMEOUT_S, TransferEngine
from repro_torch.device import new_stream, on_stream, resolve_device
from repro_torch.distributed.sharding import check_tp
from repro_torch.launch.mesh import shard_devices as make_shard_devices
from repro_torch.models.api import get_model
from repro_torch.obs.tracer import SpanTracer

PAGED_FAMILIES = ("dense", "moe", "vlm")


@dataclass
class EngineStats:
    """The reference's ``EngineStats``."""

    iterations: int = 0
    tokens_out: int = 0
    prefill_tokens: int = 0
    mode_counts: Dict[str, int] = field(default_factory=dict)
    offloaded_decodes: int = 0
    device_decodes: int = 0
    wall_time: float = 0.0
    host_busy_time: float = 0.0
    # -- measured pipeline overlap (Fig. 5, realized) ----------------------
    # device_busy_time: wall time of prefill + batch-0 dispatches (the lane
    # batch-1 is supposed to hide under).  pipeline_overlap_time: measured
    # lane-busy time beyond the union of the lanes' windows;
    # pipeline_ideal_time: everything but the longest lane (perfect packing
    # hides it all).  Serialized batch-1-only steps add ideal time with no
    # overlap, so bubble_fraction stays honest when one lane is empty.
    device_busy_time: float = 0.0
    pipeline_overlap_time: float = 0.0
    pipeline_ideal_time: float = 0.0
    pipelined_steps: int = 0
    # -- unified lane plans (K host lanes + optional device lane) ----------
    microbatched_steps: int = 0  # batch-1-only steps split into >= 2 lanes
    serial_b1_steps: int = 0  # batch-1-only steps that ran inline (no split)
    # mixed plans (short decode-only device lane) that BORROWED >= 2 host
    # lanes for their surplus batch-1 rows instead of serializing them
    borrowed_lane_steps: int = 0
    # histogram: number of host lanes K -> steps executed with that K
    lane_counts: Dict[int, int] = field(default_factory=dict)
    # per-lane dispatch wall time: "prefill" / "batch0" (device lane),
    # "host0".."hostK-1" (host lanes) and "serial" (the pipeline=False pass)
    lane_busy_time: Dict[str, float] = field(default_factory=dict)
    # -- transfer engine mirror (async swaps) ------------------------------
    swap_out_bytes: int = 0
    swap_in_bytes: int = 0
    swap_hidden_bytes: int = 0  # copy bytes overlapped by the dispatch window
    swap_wait_time: float = 0.0  # time the compute lanes blocked on joins
    # -- plan-ahead scheduling ---------------------------------------------
    planahead_hits: int = 0
    planahead_replans: int = 0
    planahead_skipped: int = 0
    # critical-path planning wall time (fresh plans + harvest waits) vs the
    # planner-thread time hidden under lane execution by accepted plans
    plan_busy_time: float = 0.0
    planahead_hidden_time: float = 0.0
    # open-loop admission control: arrivals bounced by offer()
    rejected_requests: int = 0
    # -- speculative decoding ----------------------------------------------
    # steps that ran a verify pass; drafted/accepted/rejected token counts
    # (rejected_drafts == drafted_tokens - accepted_tokens); verify wall time
    # (kept OUT of device/lane busy time, so reconcile()'s audit is
    # untouched); histogram: accepted chain length -> drafting-row count
    spec_steps: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    rejected_drafts: int = 0
    spec_busy_time: float = 0.0
    accept_len_hist: Dict[int, int] = field(default_factory=dict)
    plans: List[str] = field(default_factory=list)

    def record_plan(self, plan: BatchPlan) -> None:
        self.mode_counts[plan.mode] = self.mode_counts.get(plan.mode, 0) + 1
        if len(self.plans) < 1000:
            self.plans.append(plan.summary())

    def lane_add(self, lane: str, dt: float) -> None:
        self.lane_busy_time[lane] = self.lane_busy_time.get(lane, 0.0) + dt

    @property
    def bubble_fraction(self) -> float:
        """1 - realized/ideal overlap (0 = no bubble), clamped to [0, 1];
        0.0 with no hideable work at all."""
        if self.pipeline_ideal_time <= 0:
            return 0.0
        return min(1.0, max(
            0.0, 1.0 - self.pipeline_overlap_time / self.pipeline_ideal_time))

    @property
    def host_device_busy_ratio(self) -> float:
        """Host-attention busy time over device-lane busy time: +inf for a
        host-only workload, 0.0 when fully idle."""
        if self.device_busy_time <= 0:
            return float("inf") if self.host_busy_time > 0 else 0.0
        return self.host_busy_time / self.device_busy_time


class _SpecRow:
    """A decode-row view for batched draft verification: one token fed at an
    advanced KV position over the REAL row's page table (the same list: the
    verify pass writes its K/V into the row's own pages).  Carries exactly
    the fields :meth:`PagedExecutor.decode` reads."""

    __slots__ = ("all_tokens", "kv_len", "pages")

    def __init__(self, token: int, kv_len: int, pages: List[int]):
        self.all_tokens = (token,)
        self.kv_len = kv_len
        self.pages = pages


def _union(windows: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end] windows."""
    merged = sorted(windows)
    union = 0.0
    cur_s, cur_e = merged[0]
    for s, e in merged[1:]:
        if s > cur_e:
            union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return union + cur_e - cur_s


class NeoEngine:
    """The NEO serving engine on the card (``device="cpu"`` for the CPU).

    ``params`` is a state dict of the port's model (for example
    :func:`repro_torch.models.bridge.params_from_reference` of a reference
    tree); without it the weights are random, from a ``torch.Generator``
    seeded with ``engine_cfg.seed``.  ``shard_devices`` places the shards
    of a ``tp > 1`` engine (see the module docstring).
    """

    def __init__(
        self,
        cfg: ArchConfig,
        engine_cfg: EngineConfig = EngineConfig(),
        *,
        params: Optional[Mapping[str, Any]] = None,
        device=None,
        shard_devices: Optional[Sequence[Any]] = None,
    ):
        self.device = resolve_device(device)
        self.tp = max(1, int(engine_cfg.tp))
        self.shard_devices = make_shard_devices(self.tp, self.device, shard_devices)
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.model = get_model(cfg, device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(engine_cfg.seed)
            self.model.init(gen)
        else:
            self.model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()},
                                       strict=True)
        self.perf = PerfModel.for_arch(cfg, engine_cfg.hw_profile, engine_cfg.ewma_alpha,
                                       tp=self.tp)
        self.scheduler = NeoScheduler(cfg, engine_cfg, self.perf)
        self.paged = cfg.family in PAGED_FAMILIES and cfg.supports_offload
        if self.tp > 1 and not self.paged:
            raise ValueError("tp > 1 requires the paged engine "
                             "(dense family with offload support)")
        check_tp(cfg, self.tp)
        # the device lane's own stream (the legacy default stream would
        # serialise the host lanes' copies behind it)
        self._stream = new_stream(self.device)
        self.transfer: Optional[TransferEngine] = None
        if self.paged:
            self.pool = DualPool(cfg, engine_cfg.device_pool_pages,
                                 engine_cfg.host_pool_pages, device=self.device,
                                 shard_devices=self.shard_devices)
            # page 0 stays reserved, as in the reference (its decode scratch
            # page), so both engines see the same device page budget
            self._scratch = self.pool.device.alloc(1)
            self.host_attn = HostAttention(cfg, self.pool.host.k.numpy(),
                                           self.pool.host.v.numpy(),
                                           threads=engine_cfg.host_threads)
            self.executor = PagedExecutor(self.model, self.pool, self.host_attn,
                                          host_lanes=engine_cfg.max_host_lanes)
            self.transfer = TransferEngine(self.pool, compute_stream=self._stream,
                                           shards=self.tp)
            self._page = cfg.kv_block_size
            # the two-tier radix prefix cache (off by default: the uncached
            # path is the engine without it)
            self.prefix_cache: Optional[PrefixCache] = (
                PrefixCache(self.pool, self.transfer,
                            token_granular=engine_cfg.prefix_token_granular)
                if engine_cfg.prefix_cache else None)
            # the speculative-decoding drafter: a pure token-level oracle
            # (the serve CLI swaps in a DraftModelDrafter, tests inject
            # stubs); every KV/page decision stays in _run_spec_chain
            self.drafter = (NgramDrafter(engine_cfg.spec_ngram)
                            if engine_cfg.spec_decode else None)
        else:
            self.executor = ContiguousExecutor(
                self.model, slots=min(engine_cfg.max_requests, 64),
                capacity=engine_cfg.max_batch_tokens)
            self._page = self.executor.capacity  # 1 "page" == 1 slot for the scheduler
            self.pool = None
            self.host_attn = None
            self.prefix_cache = None
            self.drafter = None  # speculation is a paged-engine feature
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # weights and pools are in place
        self._rng = np.random.default_rng(engine_cfg.seed)
        self._next_rid = 0
        self.requests: Dict[int, Request] = {}
        self.stats = EngineStats()
        # structured tracing (repro_torch.obs): off by default; every emit
        # site guards on ``tracer is not None``
        self.tracer: Optional[SpanTracer] = None
        if engine_cfg.tracing:
            self.attach_tracer(SpanTracer(engine_cfg.trace_buffer))
        self._journal: List[Dict[str, Any]] = []
        self.clock = 0.0  # virtual clock (arrival bookkeeping in offline runs)
        # plan-ahead: one planner thread (started lazily) builds the NEXT
        # iteration's plan against a shadow of the post-step state while
        # this iteration's lanes run; _spec holds the speculation in flight
        # as (predicted signature, shadow queues, shadow requests, future)
        self._planner: Optional[ThreadPoolExecutor] = None
        self._spec: Optional[Tuple[Any, SchedQueues, Dict[int, Request], Any]] = None

    def attach_tracer(self, tracer: Optional[SpanTracer]) -> None:
        """(Re)wire ``tracer`` through every instrumented component: the
        scheduler, and on the paged path the executor, the transfer engine
        and the prefix cache (``None`` switches tracing off)."""
        self.tracer = tracer
        self.scheduler.tracer = tracer
        if self.paged:
            self.executor.tracer = tracer
            self.transfer.tracer = tracer
            if self.prefix_cache is not None:
                self.prefix_cache.tracer = tracer

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
        extras: Optional[Dict[str, np.ndarray]] = None,
    ) -> int:
        """Queue a request; ``extras`` are its model inputs beside the
        tokens (a vlm's ``patch_embeds`` [P, d], an encoder-decoder's
        ``frames`` [F, d]).  A request with extras is not prefix-cached."""
        rid = self._next_rid
        self._next_rid += 1
        req = Request(
            rid=rid,
            prompt=list(map(int, prompt)),
            max_new_tokens=int(max_new_tokens),
            arrival_time=self.clock if arrival_time is None else arrival_time,
            eos_token=eos_token,
        )
        if extras:
            req.extras = extras
        if self.prefix_cache is not None and not extras:
            # longest-prefix match (an estimate, re-matched and pinned at
            # prefill dispatch) so the scheduler prices the suffix; the
            # residency steers host placement (zero-copy host serving)
            req.cached_len, req.prefix_loc = self.prefix_cache.lookup_ex(req.prompt)
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
        if self.tracer is not None:
            self.tracer.async_begin(rid, "req", args={
                "prompt_len": len(req.prompt),
                "max_new_tokens": req.max_new_tokens})
        return rid

    def offer(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        arrival_time: Optional[float] = None,
        eos_token: Optional[int] = None,
        extras: Optional[Dict[str, np.ndarray]] = None,
    ) -> Optional[int]:
        """Admission-controlled :meth:`submit`: returns ``None`` (and counts
        the rejection) when the waitqueue is at ``max_waiting`` depth."""
        if not self.scheduler.has_capacity():
            self.stats.rejected_requests += 1
            if self.tracer is not None:
                self.tracer.instant("engine", "reject", {"reason": "max_waiting"})
            return None
        return self.submit(prompt, max_new_tokens, arrival_time=arrival_time,
                           eos_token=eos_token, extras=extras)

    def cancel(self, rid: int) -> bool:
        """Mid-flight departure (client disconnect / streaming abort): free
        the request's KV, drop it from the scheduler queues, and mark it
        ABORTED.  Tokens already streamed stay with the caller.  Call
        between steps (transfers drain at the end of every step, so no copy
        in flight references the pages)."""
        req = self.requests.get(rid)
        if req is None or req.state in (RequestState.FINISHED, RequestState.ABORTED):
            return False
        if req.pages:
            if self.paged:
                self.pool.pool(req.location).free(req.pages)
            else:
                self.executor.free_slot(req.pages[0])
            req.pages = []
        sched = self.scheduler
        for q in (sched.waitq, sched.gpu_runq, sched.cpu_runq):
            if req in q:
                q.remove(req)
        req.state = RequestState.ABORTED
        req.finish_time = self.clock
        if self.tracer is not None:
            self.tracer.async_end(rid, "req", args={
                "outcome": "cancelled", "tokens": len(req.out_tokens)})
        return True

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _pool_view(self) -> PoolView:
        if self.paged:
            dev_evict = host_evict = 0
            if self.prefix_cache is not None:
                # unpinned cached pages are reclaimable on demand (make_room),
                # so the scheduler plans against free + evictable
                dev_evict = self.prefix_cache.evictable_pages("gpu")
                host_evict = self.prefix_cache.evictable_pages("cpu")
            return PoolView(
                page_size=self._page,
                device_free=self.pool.device.free_pages + dev_evict,
                host_free=self.pool.host.free_pages + host_evict,
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
        if self.tracer is not None:
            self.tracer.async_instant(req.rid, "tok", args={"token": tok})

    def _finish(self, req: Request, now: float) -> None:
        req.state = RequestState.FINISHED
        req.finish_time = now
        if self.tracer is not None:
            self.tracer.async_end(req.rid, "req", args={
                "outcome": "finished", "tokens": len(req.out_tokens)})
        if req.pages:
            if self.paged:
                if self.prefix_cache is not None:
                    # the tree adopts the pages (its own reference) before
                    # the request releases its own: adopted and still-shared
                    # pages survive, the rest return to the free list
                    self.prefix_cache.insert_request(req)
                self.pool.pool(req.location).free(req.pages)
            else:
                self.executor.free_slot(req.pages[0])
        req.pages = []

    # ------------------------------------------------------------------
    # plan-ahead scheduling
    # ------------------------------------------------------------------
    # While iteration N's lanes run, a planner thread builds iteration N+1's
    # plan against a SHADOW of the predicted post-step queues and pool
    # counters.  At step N+1 a signature over every plan input (per-request
    # scheduling fields plus the free-page view) decides: a match adopts the
    # plan (remapped shadow -> real), a mismatch (arrival, cancel, eos
    # finish, anything the prediction could not see) replans.  Prediction
    # accuracy only moves the hit rate, never the tokens: per-row compute
    # does not depend on the plan's shape.

    @staticmethod
    def _extras_batch(reqs: List[Request], S: int) -> Dict[str, torch.Tensor]:
        """The prefill batch's extras, each key stacked over ``reqs`` (the
        reference's ``_extras_batch``): a request without the key gets a
        zero row of the others' shape, so a text-only request batched with
        an image request sees zero patch embeddings at its first positions
        whenever the padded ``S`` reaches their count (a reference quirk the
        port carries, ROADMAP queue 3).  ``S`` is unused, as there."""
        ex = [r.extras for r in reqs]
        if not any(ex):
            return {}
        out = {}
        for k in sorted(set().union(*[set(e) for e in ex if e])):
            like = next(np.asarray(e[k]) for e in ex if e and k in e)
            out[k] = torch.from_numpy(np.stack([np.asarray(e[k]) if e and k in e
                                                else np.zeros_like(like) for e in ex]))
        return out

    @staticmethod
    def _sig_req(r: Request) -> tuple:
        return (r.rid, r.state.value, r.location, len(r.prompt),
                len(r.out_tokens), len(r.pages), r.skipped, r.cached_len,
                r.prefix_loc, r.max_new_tokens)

    @staticmethod
    def _sig_of(waitq, gpu_runq, cpu_runq, dev_free: int, host_free: int) -> tuple:
        f = NeoEngine._sig_req
        return (tuple(f(r) for r in waitq), tuple(f(r) for r in gpu_runq),
                tuple(f(r) for r in cpu_runq), dev_free, host_free)

    def _signature(self) -> tuple:
        pv = self._pool_view()
        s = self.scheduler
        return self._sig_of(s.waitq, s.gpu_runq, s.cpu_runq, pv.device_free, pv.host_free)

    def _build_shadow(self, plan: BatchPlan):
        """Predict the post-step scheduler/pool state for ``plan`` (right
        after commit, before dispatch) and clone it into shadows the planner
        thread can mutate.  Returns ``(state, shadows, pools_pred,
        sig_pred)``, or None when the prediction left the scheduler's
        budget or, with the prefix cache on, when the step touches the radix
        tree (prefill pins, frees of possibly shared pages by preemption or
        swaps, finish-time inserts, growth under eviction pressure)."""
        page = self._page
        cache_on = self.prefix_cache is not None
        sched = self.scheduler
        if cache_on and (plan.prefill or plan.preempt or plan.swap_out or plan.swap_in):
            return None
        # pool counters at the end of the step: swaps' page accounting moved
        # at launch, except swap-in source pages, which return to the host
        # pool at join (drained by the step barrier)
        dev_raw = self.pool.device.free_pages
        host_raw = self.pool.host.free_pages + sum(len(r.pages) for r in plan.swap_in)

        def _running(rs: List[Request]) -> List[Request]:
            return [r for r in rs
                    if r.state == RequestState.RUNNING and r not in plan.prefill]

        rows = (_running(plan.decode_gpu) + _running(plan.decode_cpu0)
                + _running(plan.decode_cpu1))
        shadows: Dict[int, Request] = {}

        def clone(r: Request) -> Request:
            sr = copy.copy(r)
            sr.out_tokens = list(r.out_tokens)
            sr.pages = list(r.pages)
            shadows[r.rid] = sr
            return sr

        st = SchedQueues(
            waitq=deque(clone(r) for r in sched.waitq),
            gpu_runq=[clone(r) for r in sched.gpu_runq],
            cpu_runq=[clone(r) for r in sched.cpu_runq],
        )
        # decode-row page growth (the dispatch predicate on the pre-emission
        # kv_len) + token emission; -1 never equals an eos token, so a real
        # eos finish falsifies the signature instead of matching it
        for r in rows:
            sr = shadows[r.rid]
            if r.kv_len % page == 0 and r.kv_len // page >= len(r.pages):
                if cache_on and (host_raw if r.location == "cpu" else dev_raw) < 1:
                    return None  # make_room would evict: not predictable
                if r.location == "cpu":
                    host_raw -= 1
                else:
                    dev_raw -= 1
                sr.pages.append(-1)
            sr.out_tokens.append(-1)
        # prefill allocation + first-token emission (replayed prefills
        # re-derive their last token and do not emit)
        for r in plan.prefill:
            sr = shadows[r.rid]
            npages = -(-r.prefill_len // page)
            if r in plan.prefill_to_host:
                host_raw -= npages
            else:
                dev_raw -= npages
            sr.pages = [-1] * npages
            if not sr.out_tokens:
                sr.out_tokens.append(-1)
        # finishes: only the max_new_tokens bound is predictable
        for r in plan.prefill + plan.decode_rows:
            sr = shadows.get(r.rid)
            if sr is None or sr.state != RequestState.RUNNING:
                continue
            if len(sr.out_tokens) >= sr.max_new_tokens:
                if cache_on:
                    return None  # the finish inserts into the radix tree
                if sr.location == "cpu":
                    host_raw += len(sr.pages)
                else:
                    dev_raw += len(sr.pages)
                sr.state = RequestState.FINISHED
                sr.pages = []
        st.gpu_runq = [r for r in st.gpu_runq if r.state != RequestState.FINISHED]
        st.cpu_runq = [r for r in st.cpu_runq if r.state != RequestState.FINISHED]
        if dev_raw < 0 or host_raw < 0:
            return None  # the prediction diverged from the scheduler's budget
        dev_ev = host_ev = 0
        if cache_on:
            # a pure decode step leaves the tree alone (everything else
            # returned None above), so the evictable counts stand
            dev_ev = self.prefix_cache.evictable_pages("gpu")
            host_ev = self.prefix_cache.evictable_pages("cpu")
        pools_pred = PoolView(
            page_size=page,
            device_free=dev_raw + dev_ev,
            host_free=host_raw + host_ev,
            device_total=self.pool.device.num_pages - 1,
            host_total=self.pool.host.num_pages,
        )
        sig_pred = self._sig_of(st.waitq, st.gpu_runq, st.cpu_runq,
                                pools_pred.device_free, pools_pred.host_free)
        return st, shadows, pools_pred, sig_pred

    def _launch_planahead(self, plan: BatchPlan) -> None:
        """Start the speculative plan of the NEXT iteration (after commit,
        before dispatch, so the planner runs under this step's lanes).  The
        planner thread touches only shadow requests and its own pool view."""
        self._spec = None
        shadow = self._build_shadow(plan)
        if shadow is None:
            self.stats.planahead_skipped += 1
            if self.tracer is not None:
                self.tracer.instant("engine", "plan_skip")
            return
        st, shadows, pools_pred, sig_pred = shadow
        sched = self.scheduler
        tr = self.tracer

        def _plan_spec():
            t0 = time.perf_counter()
            p = sched.plan(pools_pred, state=st)
            dur = time.perf_counter() - t0
            if tr is not None:
                tr.emit("planner", "spec_plan", t0, t0 + dur, {"dur": dur})
            return p, dur

        if self._planner is None:
            self._planner = ThreadPoolExecutor(max_workers=1,
                                               thread_name_prefix="neo-planner")
        self._spec = (sig_pred, st, shadows, self._planner.submit(_plan_spec))

    def _take_plan(self) -> Tuple[Optional[BatchPlan], bool]:
        """Harvest the speculation in flight: ``(plan, False)`` on a hit,
        ``(None, had_spec)`` otherwise (the caller plans fresh; had_spec
        marks a REPLAN whose fresh planning time was hideable)."""
        spec, self._spec = self._spec, None
        if spec is None:
            return None, False
        sig_pred, st, shadows, fut = spec
        tr = self.tracer
        t0 = time.perf_counter()
        err = False
        try:
            plan_s, dur = fut.result(timeout=WAIT_TIMEOUT_S)
        except Exception:
            err = True
        # a harvest wait (planning outlasted the lanes) is critical-path time
        wait = time.perf_counter() - t0
        self.stats.plan_busy_time += wait
        if tr is not None:
            tr.emit("engine", "plan_harvest", t0, t0 + wait, {"dur": wait})
        if err or self._signature() != sig_pred:
            self.stats.planahead_replans += 1
            return None, True
        real = self.requests

        def rmap(rs: List[Request]) -> List[Request]:
            return [real[sr.rid] for sr in rs]

        plan = BatchPlan(
            mode=plan_s.mode,
            prefill=rmap(plan_s.prefill),
            prefill_to_host=rmap(plan_s.prefill_to_host),
            decode_gpu=rmap(plan_s.decode_gpu),
            decode_cpu0=rmap(plan_s.decode_cpu0),
            decode_cpu1=rmap(plan_s.decode_cpu1),
            swap_out=rmap(plan_s.swap_out),
            swap_in=rmap(plan_s.swap_in),
            preempt=rmap(plan_s.preempt),
            lane_splits=list(plan_s.lane_splits),
            spec_k=plan_s.spec_k,
            est_iter_time=plan_s.est_iter_time,
            est_tokens=plan_s.est_tokens,
            stages=plan_s.stages,
        )
        # planning's own queue/request mutations ran on the shadows; apply
        # them to the real state as a fresh plan would have: aging
        # (skipped), admission aborts, and the post-plan waitqueue
        for sr in shadows.values():
            r = real.get(sr.rid)
            if r is None:
                continue
            r.skipped = sr.skipped
            if sr.state == RequestState.ABORTED and r.state == RequestState.WAITING:
                r.state = RequestState.ABORTED
        self.scheduler.waitq = deque(real[sr.rid] for sr in st.waitq)
        self.stats.planahead_hits += 1
        # the planner's time was hidden under the previous step's lanes:
        # realized AND ideal overlap both grow by it
        self.stats.planahead_hidden_time += dur
        self.stats.pipeline_overlap_time += dur
        self.stats.pipeline_ideal_time += dur
        if tr is not None:
            tr.instant("engine", "plan_adopt", {"dur": dur})
        return plan, False

    # ------------------------------------------------------------------
    # one iteration
    # ------------------------------------------------------------------
    def _host_busy_total(self) -> float:
        """Host-attention busy seconds of the engine's instance and the
        executor's per-shard instances (gather-TP's batch-0 host rows)."""
        return self.host_attn.busy_time + sum(h.busy_time for h in self.executor.host_shards)

    def _host_prefix_busy_total(self) -> float:
        return self.host_attn.prefix_busy_time + sum(
            h.prefix_busy_time for h in self.executor.host_shards)

    def step(self, now: Optional[float] = None) -> List[Tuple[int, int]]:
        """Run one inference iteration; returns [(rid, new_token), ...]."""
        with on_stream(self._stream):
            return self._step(now)

    def _step(self, now: Optional[float]) -> List[Tuple[int, int]]:
        t0 = time.perf_counter()
        now = self.clock if now is None else now
        self.clock = now
        host_busy0 = self._host_busy_total() if self.paged else 0.0
        prefix_busy0 = self._host_prefix_busy_total() if self.paged else 0.0
        dev_busy0 = self.stats.device_busy_time
        spec_busy0 = self.stats.spec_busy_time
        swap_busy0 = self.transfer.stats.busy_time if self.transfer else 0.0

        # -- PLAN: adopt the plan speculated during the previous iteration
        #    when its predicted state still matches reality
        plan, replanned = (self._take_plan() if self.paged else (None, False))
        if plan is None:
            p0 = time.perf_counter()
            plan = self.scheduler.plan(self._pool_view())
            dt = time.perf_counter() - p0
            self.stats.plan_busy_time += dt
            if self.tracer is not None:
                self.tracer.emit("engine", "plan_fresh", p0, p0 + dt,
                                 {"dur": dt, "hideable": replanned})
            if replanned:
                # a falsified speculation: this planning time WAS hideable
                self.stats.pipeline_ideal_time += dt
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
            # perf-model refresh from MEASURED stage times (EWMA); the
            # reference refreshes it on the paged path only
            host_busy = self._host_busy_total() - host_busy0
            self.stats.host_busy_time += host_busy
            ts = self.transfer.stats
            self.stats.swap_out_bytes = ts.bytes_out
            self.stats.swap_in_bytes = ts.bytes_in
            self.stats.swap_wait_time = ts.wait_time
            # the shards' host attention runs concurrently, so its summed
            # busy time is about tp x the wall time the perf model prices
            # (an exact no-op at tp=1)
            self.perf.observe_iteration(
                plan.stages,
                host_busy=host_busy / self.tp,
                device_busy=self.stats.device_busy_time - dev_busy0,
                swap_busy=ts.busy_time - swap_busy0,
                host_prefix_busy=(self._host_prefix_busy_total() - prefix_busy0) / self.tp,
                spec_busy=self.stats.spec_busy_time - spec_busy0,
                pipelined=self.engine_cfg.pipeline and plan.mode != "serial",
            )
        if self.tracer is not None:
            self.tracer.emit("engine", "step", t0, time.perf_counter(),
                             {"iter": self.stats.iterations})
            self.tracer.counter("queues", self.scheduler.queue_depths())
            if self.paged:
                self.tracer.counter("pool_free", {
                    "device": self.pool.device.free_pages,
                    "host": self.pool.host.free_pages})
        return emitted

    def _step_paged(self, plan: BatchPlan, now: float,
                    emitted: List[Tuple[int, int]]) -> None:
        # "serial"-mode plans (strawman #1) execute without overlap by
        # definition; everything else pipelines when enabled
        pipelined = self.engine_cfg.pipeline and plan.mode != "serial"
        tr = self.tracer
        it = self.stats.iterations
        if tr is not None:
            # copy handles launched this step stamp their spans with the
            # iteration id, pairing them with the dispatch window below
            self.transfer.trace_iter = it

        # ==== LAUNCH =========================================================
        # recompute preemption (both pools full): drop KV, requeue
        for r in plan.preempt:
            self.pool.pool(r.location).free(r.pages)  # refcounted: shared pages survive
            r.pages = []
            r.location = "gpu"
            r.cached_len = 0  # the replay re-matches the tree at dispatch
            r.prefix_loc = None
        if self.prefix_cache is not None:
            # the scheduler planned against free + evictable cached pages:
            # evict (demote first) so the promised room exists for the swaps.
            # The device pass runs first: it may demote device nodes INTO the
            # host pool, so the host room is made afterwards
            need_dev = sum(len(r.pages) for r in plan.swap_in)
            if need_dev:
                self.prefix_cache.make_room("gpu", need_dev)
            need_host = sum(len(r.pages) for r in plan.swap_out)
            if need_host:
                self.prefix_cache.make_room("cpu", need_host)
        # swaps: page accounting moves now; the data moves on the copy
        # streams (pipelined) or inline (serial)
        out_handles: List = []
        in_handles: List = []
        if pipelined:
            out_handles = [self.transfer.swap_out(r) for r in plan.swap_out]
            in_handles = [self.transfer.swap_in(r) for r in plan.swap_in]
        else:
            for r in plan.swap_out:
                self.pool.swap_request(r, "cpu")
            for r in plan.swap_in:
                self.pool.swap_request(r, "gpu")
        self.scheduler.commit(plan)
        if pipelined and self.engine_cfg.planahead:
            self._launch_planahead(plan)
        dispatch_t0 = time.perf_counter()  # compute-window start (hidden bytes)

        # Page allocation in the serial path's order, the same page
        # assignment on both paths: prefill pages, then decode-row pages in
        # gpu/cpu0/cpu1 plan order; with the prefix cache on, decode rows
        # first (the reference's two orders).  Replayed prefills (recompute
        # preemption) re-derive their last token and do not emit.
        page = self._page
        cache = self.prefix_cache

        def _running(rs: List[Request]) -> List[Request]:
            return [r for r in rs
                    if r.state == RequestState.RUNNING and r not in plan.prefill]

        rows0 = _running(plan.decode_gpu) + _running(plan.decode_cpu0)
        rows1 = _running(plan.decode_cpu1)
        rows = rows0 + rows1
        host_flags: List[bool] = []

        def _grow_decode_pages() -> None:
            for r in rows:
                if r.kv_len % page == 0 and r.kv_len // page >= len(r.pages):
                    if cache is not None:
                        cache.make_room(r.location, 1)
                    r.pages = r.pages + self.pool.pool(r.location).alloc(1)
                host_flags.append(r.location == "cpu")

        if cache is not None:
            # decode rows were budgeted by the scheduler before the prefills:
            # grow their pages first, so a prefill's pins cannot take the
            # evictable pages the rows were admitted against
            _grow_decode_pages()
        to_host = self._alloc_prefills(plan)
        if cache is None:
            _grow_decode_pages()

        # ---- unified lane plan -------------------------------------------
        # One optional DEVICE lane (prefill + batch-0, engine thread) plus K
        # >= 0 HOST lanes over the scheduler's partition of batch-1 (rows
        # preempted or finished since planning filtered out).  Host lanes
        # launch FIRST on the lane threads, so their lane-scoped swap-out
        # joins and host attention overlap the whole device lane; with no
        # device lane the LAST host lane runs inline on the engine thread.
        rows1_ids = set(id(r) for r in rows1)
        lane_rows = [[r for r in lane if id(r) in rows1_ids] for lane in plan.host_lanes()]
        lane_rows = [lane for lane in lane_rows if lane]
        has_dev_lane = bool(plan.prefill or rows0)
        n_lanes = len(lane_rows)
        lane_windows: List[Tuple[float, float]] = []
        futures: List[Tuple[int, Any]] = []
        inline_idx: Optional[int] = None
        if pipelined and lane_rows:
            def _pre(rws: List[Request]):
                # lane-scoped join: the swap-outs a lane depends on complete
                # right before ITS host attention reads the pages
                return lambda: self.transfer.join_requests(rws, kind="out")
            thread_lanes = lane_rows if has_dev_lane else lane_rows[:-1]
            for li, rws in enumerate(thread_lanes):
                futures.append((li, self.executor.submit_host_lane(
                    rws, pre=_pre(rws), lane=li + 1)))
            if not has_dev_lane:
                inline_idx = n_lanes - 1

        # device lane: each dispatch's (start, end) window is kept apart so
        # overlap accounting excludes the engine-thread gaps between them;
        # each ends at the synchronising copy of its logits to the host
        dev_windows: List[Tuple[float, float]] = []
        if plan.prefill:
            t0 = time.perf_counter()
            logits = self.executor.prefill(plan.prefill, to_host, self._extras_batch)
            dev_windows.append((t0, time.perf_counter()))
            self.stats.device_busy_time += dev_windows[-1][1] - t0
            self.stats.lane_add("prefill", dev_windows[-1][1] - t0)
            if tr is not None:
                tr.emit("device", "prefill", t0, dev_windows[-1][1],
                        {"iter": it, "rows": len(plan.prefill)})
                for r in plan.prefill:
                    tr.async_begin(r.rid, "prefill", t=t0)
                    tr.async_end(r.rid, "prefill", t=dev_windows[-1][1])
            self.stats.prefill_tokens += sum(r.suffix_len for r in plan.prefill)
            for i, r in enumerate(plan.prefill):
                if not r.out_tokens:
                    self._emit(r, logits[i], now, emitted)

        if rows:
            if pipelined:
                # swap-ins join before batch-0 reads the pool; swap-outs
                # join lane-scoped on the lane threads
                self.transfer.join(in_handles)
                logits0 = None
                if rows0:
                    t0 = time.perf_counter()
                    logits0 = self.executor.decode_batch0(rows0, host_flags[: len(rows0)])
                    dev_windows.append((t0, time.perf_counter()))
                    self.stats.device_busy_time += dev_windows[-1][1] - t0
                    self.stats.lane_add("batch0", dev_windows[-1][1] - t0)
                    if tr is not None:
                        tr.emit("device", "batch0", t0, dev_windows[-1][1],
                                {"iter": it, "rows": len(rows0)})
                lane_windows = [(0.0, 0.0)] * n_lanes
                lane_logits: List[Optional[np.ndarray]] = [None] * n_lanes
                inline_hb = 0.0
                if inline_idx is not None:
                    rws = lane_rows[inline_idx]
                    self.transfer.join_requests(rws, kind="out")
                    hb0 = self.host_attn.busy_time
                    t0b = time.perf_counter()
                    lane_logits[inline_idx] = self.executor.decode_host_lane(
                        rws, lane=inline_idx + 1)
                    lane_windows[inline_idx] = (t0b, time.perf_counter())
                    inline_hb = self.host_attn.busy_time - hb0
                for li, fut in futures:
                    lane_logits[li], lane_windows[li] = fut.result(timeout=WAIT_TIMEOUT_S)
                row_logits: List[np.ndarray] = []
                if rows0:
                    row_logits.extend(logits0)
                for lg in lane_logits:
                    row_logits.extend(lg)
                # ---- measured overlap over N lanes: realized = lane-busy
                # time beyond the union of the windows; ideal = everything
                # but the longest lane
                for li, w in enumerate(lane_windows):
                    self.stats.lane_add(f"host{li}", w[1] - w[0])
                    if tr is not None:
                        a: Dict[str, Any] = {"iter": it, "rows": len(lane_rows[li])}
                        if li == inline_idx:
                            a["inline"] = True
                            a["host_busy"] = inline_hb
                        tr.emit(f"host{li}", "lane", w[0], w[1], a)
                interval_lanes: List[List[Tuple[float, float]]] = []
                if dev_windows:
                    interval_lanes.append(list(dev_windows))
                interval_lanes += [[w] for w in lane_windows]
                busy = [sum(e - s for s, e in lw) for lw in interval_lanes]
                if len(interval_lanes) >= 2:
                    total = sum(busy)
                    union = _union([w for lw in interval_lanes for w in lw])
                    self.stats.pipeline_overlap_time += max(0.0, total - union)
                    self.stats.pipeline_ideal_time += max(0.0, total - max(busy))
                    self.stats.pipelined_steps += 1
                    if n_lanes >= 2:
                        if has_dev_lane:
                            self.stats.borrowed_lane_steps += 1
                        else:
                            self.stats.microbatched_steps += 1
                elif inline_idx is not None:
                    # fully serialized batch-1-only step: the hideable half
                    # (the shorter of host attention vs the linear rest)
                    # counts as ideal-but-unrealized overlap
                    self.stats.pipeline_ideal_time += max(
                        0.0, min(inline_hb, busy[0] - inline_hb))
                    self.stats.serial_b1_steps += 1
                if n_lanes:
                    # the EXECUTED lane count (after the preemption filter)
                    self.stats.lane_counts[n_lanes] = (
                        self.stats.lane_counts.get(n_lanes, 0) + 1)
            else:
                t0 = time.perf_counter()
                logits = self.executor.decode(rows, host_flags)
                dev_windows.append((t0, time.perf_counter()))
                self.stats.device_busy_time += dev_windows[-1][1] - t0
                self.stats.lane_add("serial", dev_windows[-1][1] - t0)
                if tr is not None:
                    tr.emit("device", "serial", t0, dev_windows[-1][1],
                            {"iter": it, "rows": len(rows)})
                row_logits = list(logits)
            self.stats.offloaded_decodes += sum(host_flags)
            self.stats.device_decodes += len(rows) - sum(host_flags)
            for i, r in enumerate(rows):
                self._emit(r, row_logits[i], now, emitted)

            # speculative draft -> verify -> accept: AFTER the base emission
            # (the verify pass's first pseudo-row scores the token just
            # emitted) and BEFORE the drain, so rolled-back pages return to
            # the pool within this step
            if plan.spec_k > 0 and self.drafter is not None:
                self._run_spec_chain(plan, rows, now, emitted)

        # ==== JOIN: barrier on every transfer no dispatch consumed (e.g.
        # gpu_only swap-outs whose victims do not decode this iteration), so
        # every step ends with the pools consistent
        if pipelined:
            d0 = time.perf_counter() if tr is not None else 0.0
            self.transfer.drain()
            if tr is not None:
                tr.emit("engine", "drain", d0, time.perf_counter(), {"iter": it})
            # bytes hidden under compute: copy windows overlapped by this
            # step's dispatch window (page tables + prefill + every lane)
            dev_end = dev_windows[-1][1] if dev_windows else None
            lanes_end = max((w[1] for w in lane_windows), default=None)
            win_end = max(filter(None, (dev_end, lanes_end)), default=None)
            if win_end is not None:
                if tr is not None:
                    tr.emit("engine", "dispatch", dispatch_t0, win_end, {"iter": it})
                for h in out_handles + in_handles:
                    self.stats.swap_hidden_bytes += h.hidden_bytes(dispatch_t0, win_end)

    # -- speculative decoding (draft -> verify -> accept) ---------------------
    def _run_spec_chain(self, plan: BatchPlan, rows: List[Request], now: float,
                        emitted: List[Tuple[int, int]]) -> None:
        """Batched draft verification over this step's decode rows in ONE
        extra pass of the unchanged decode path (the reference's).

        Each drafting row expands into ``len(drafts) + 1`` pseudo-rows
        (:class:`_SpecRow`) at successive KV positions over its own page
        table: pseudo-row 0 feeds the token the step just emitted (its
        logits are the next serial token, a free bonus even for a row that
        drafted nothing), pseudo-row ``j >= 1`` feeds draft ``D_{j-1}`` at
        position ``kv_len + j``.  One :meth:`PagedExecutor.decode` call
        verifies every position: within each layer it writes all rows' new
        K/V before any row attends (device rows: the pool scatter precedes
        the paged decode kernel; host rows: ``HostAttention.run_layer``
        appends before attending), so pseudo-row ``j`` attends over the
        fresh K/V of pseudo-rows ``< j`` as serial decode would.  Its logits
        are the serial ones at that position when every shallower feed
        matched the serial token, which is exactly the accept condition
        walked below: every emitted token is the one non-speculative greedy
        decode gives.  On the card this also rests on a row's logits not
        depending on its pass's row count (the executor's row buckets, K1's
        per-row page ranges; measured by ``tests/test_torch_spec_card.py``).

        Rollback: ``out_tokens`` grows only through :meth:`_emit` in the
        accept walk, so a rejection leaves the row at its serial state; the
        rejected tail's K/V sits at positions ``>= kv_len``, unread and
        overwritten by the next serial feed.  Pages are rolled back only
        past the count the row held before the chain, so a page shared with
        the prefix cache is never freed here.  Pool exhaustion during the
        up-front growth caps a row's depth to the positions its pages cover
        (a row whose base position cannot be covered skips the chain).

        Verify wall time accrues to ``spec_busy_time`` and the ``spec`` span
        track only; the device and lane busy times are untouched.
        """
        if self.engine_cfg.decode_sample != "greedy":
            return
        page = self._page
        cand = [r for r in rows if r.state == RequestState.RUNNING and not r.is_done()]
        if not cand:
            return
        cand_drafts: Dict[int, List[int]] = {}
        for r in cand:
            cap = min(plan.spec_k, r.max_new_tokens - len(r.out_tokens) - 1)
            cand_drafts[r.rid] = (list(self.drafter.propose(r.all_tokens, cap)[:cap])
                                  if cap > 0 else [])
        if not any(cand_drafts.values()):
            return  # nothing drafted anywhere: no verify pass
        # up-front page growth: a depth-d row writes K/V at kv_len .. kv_len
        # + d, so it needs (kv_len + d) // page + 1 pages; exhaustion caps
        # the depth, surplus pages roll back in the accept walk
        erows: List[Request] = []
        drafts: List[List[int]] = []
        base_pages: List[int] = []
        for r in cand:
            d = cand_drafts[r.rid]
            pool = self.pool.pool(r.location)
            pre = len(r.pages)
            need = (r.kv_len + len(d)) // page + 1
            while len(r.pages) < need:
                if self.prefix_cache is not None:
                    self.prefix_cache.make_room(r.location, 1)
                if pool.free_pages < 1:
                    break
                r.pages = r.pages + pool.alloc(1)
            max_depth = len(r.pages) * page - 1 - r.kv_len
            if max_depth < 0:
                continue  # base write position uncovered: plain decode only
            erows.append(r)
            drafts.append(d[:max_depth])
            base_pages.append(pre)
        if not erows:
            return
        tr = self.tracer
        t0 = time.perf_counter()
        prows: List[_SpecRow] = []
        pflags: List[bool] = []
        starts: List[int] = []
        for i, r in enumerate(erows):
            starts.append(len(prows))
            for j, tok in enumerate([r.all_tokens[-1]] + drafts[i]):
                prows.append(_SpecRow(tok, r.kv_len + j, r.pages))
                pflags.append(r.location == "cpu")
        logits = self.executor.decode(prows, pflags)
        # ---- accept walk: emit serially from the verified logits ---------
        drafted = sum(len(d) for d in drafts)
        accepted_total = 0
        for i, r in enumerate(erows):
            d = drafts[i]
            acc = 0
            for j in range(len(d) + 1):
                if r.is_done():
                    break
                self._emit(r, logits[starts[i] + j], now, emitted)
                if j < len(d):
                    if r.out_tokens[-1] == d[j]:
                        acc += 1
                    else:
                        break  # the emitted token IS the serial correction
            accepted_total += acc
            if d:
                self.stats.accept_len_hist[acc] = self.stats.accept_len_hist.get(acc, 0) + 1
            # roll back pages grown past the final K/V coverage, never below
            # the pre-chain count (shared prefix pages live there)
            need = max(base_pages[i], r.kv_len // page + 1)
            if len(r.pages) > need:
                extra = r.pages[need:]
                r.pages = r.pages[:need]
                self.pool.pool(r.location).free(extra)
        t1 = time.perf_counter()
        self.stats.spec_steps += 1
        self.stats.drafted_tokens += drafted
        self.stats.accepted_tokens += accepted_total
        self.stats.rejected_drafts += drafted - accepted_total
        self.stats.spec_busy_time += t1 - t0
        self.perf.observe_accept(drafted, accepted_total)
        if tr is not None:
            tr.emit("spec", "verify", t0, t1,
                    {"iter": self.stats.iterations, "k": plan.spec_k,
                     "rows": len(erows), "pseudo_rows": len(prows),
                     "drafted": drafted, "accepted": accepted_total})

    def _alloc_prefills(self, plan: BatchPlan) -> List[bool]:
        """Allocate each prefill's pages in its pool; returns whether each
        prefill that stays in ``plan.prefill`` goes to the host.  With the
        prefix cache on, the authoritative match pins the shared prefix
        pages and makes the copy-on-write page, and only the suffix pages
        are new.  The scheduler admitted each prefill against its submit-time
        match; a match that shrank since (the tree changed) is released, and
        the prefill falls back to a cold one or, when its suffix then busts
        the batch's token budget or the pool lacks the pages, is deferred to
        the head of the waitqueue, as in the reference."""
        page = self._page
        cache = self.prefix_cache
        token_budget = (self.engine_cfg.max_batch_tokens
                        - len(plan.decode_gpu) - len(plan.decode_cpu0))
        to_host: List[bool] = []
        deferred: List[Request] = []
        for r in plan.prefill:
            host = r in plan.prefill_to_host
            target = "cpu" if host else "gpu"
            pool = self.pool.pool(target)
            total = -(-r.prefill_len // page)
            if cache is None or r.extras is not None:
                # not cacheable (no cache, or model inputs beside the tokens,
                # which the suffix prefill does not take)
                r.cached_len = 0
                if cache is not None:
                    # admitted against free + evictable tree pages: reclaim
                    # them, or defer
                    cache.make_room(target, total)
                    if pool.free_pages < total:
                        deferred.append(r)
                        continue
                r.pages = pool.alloc(total)
                token_budget -= r.suffix_len
                to_host.append(host)
                continue
            shared, cow, r.cached_len = cache.acquire(r.prefill_tokens, target)
            mine = shared + ([cow] if cow is not None else [])
            if r.suffix_len > token_budget:
                # the match shrank and the suffix busts the token budget:
                # release the pins, unwind the acquire (the retry re-runs it)
                # and the lookup, and defer
                if mine:
                    pool.free(mine)
                cache.retract_acquire()
                cache.retract_lookup(len(r.prefill_tokens))
                r.cached_len = 0
                deferred.append(r)
                continue
            fresh = total - len(mine)
            cache.make_room(target, fresh)
            if pool.free_pages >= fresh:
                r.pages = mine + pool.alloc(fresh)
            else:
                # the match outgrew the scheduler's page budget: release the
                # prefix (the pages stay tree-owned and evictable) and fall
                # back to a cold prefill; the lookup stays counted (a miss)
                if mine:
                    pool.free(mine)
                cache.retract_acquire()
                r.cached_len = 0
                if r.suffix_len > token_budget:
                    cache.retract_lookup(len(r.prefill_tokens))
                    deferred.append(r)
                    continue
                cache.make_room(target, total)
                if pool.free_pages < total:
                    # evictable pages were pinned by an earlier prefill this
                    # step: defer; the retry re-runs acquire
                    cache.retract_lookup(len(r.prefill_tokens))
                    deferred.append(r)
                    continue
                r.pages = pool.alloc(total)
            token_budget -= r.suffix_len
            to_host.append(host)
        for r in reversed(deferred):
            # unwind the commit: back to the head of the waitqueue, planned
            # again next iteration against the true pool state
            plan.prefill.remove(r)
            if r in plan.prefill_to_host:
                plan.prefill_to_host.remove(r)
            for q in (self.scheduler.gpu_runq, self.scheduler.cpu_runq):
                if r in q:
                    q.remove(r)
            r.state = RequestState.WAITING
            r.location = "gpu"
            self.scheduler.waitq.appendleft(r)
        return to_host

    def _step_contiguous(self, plan: BatchPlan, now: float,
                         emitted: List[Tuple[int, int]]) -> None:
        # the device spans carry the windows lane_add records, so
        # reconcile() holds these lanes too
        tr = self.tracer
        it = self.stats.iterations
        self.scheduler.commit(plan)
        t0 = time.perf_counter()
        for r in plan.prefill:
            slot = self.executor.alloc_slot()
            r.pages = [slot]
            extras = {k: np.asarray(v)[None] for k, v in r.extras.items()} if r.extras else None
            logits = self.executor.prefill(r, slot, extras)
            self.stats.prefill_tokens += r.prompt_len
            self._emit(r, logits, now, emitted)
        if plan.prefill:
            t1 = time.perf_counter()
            self.stats.device_busy_time += t1 - t0
            self.stats.lane_add("prefill", t1 - t0)
            if tr is not None:
                tr.emit("device", "prefill", t0, t1,
                        {"iter": it, "rows": len(plan.prefill)})
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
            t1 = time.perf_counter()
            self.stats.device_busy_time += t1 - t0
            self.stats.lane_add("serial", t1 - t0)
            if tr is not None:
                tr.emit("device", "serial", t0, t1, {"iter": it, "rows": len(rows)})
            self.stats.device_decodes += len(rows)
            for r in rows:
                self._emit(r, logits[r.pages[0]], now, emitted)

    # ------------------------------------------------------------------
    # lifecycle and drivers
    # ------------------------------------------------------------------
    def close(self) -> None:
        """Join and stop the planner, transfer and lane threads and the
        host-attention workers (idempotent; each wait has a timeout).  A
        transfer that failed in flight surfaces its error here, after every
        worker pool has been torn down."""
        spec, self._spec = self._spec, None
        if spec is not None:
            spec[3].cancel()
        if self._planner is not None:
            self._planner.shutdown(wait=False, cancel_futures=True)
            for t in list(getattr(self._planner, "_threads", ())):
                t.join(WAIT_TIMEOUT_S)
            self._planner = None
        try:
            if self.transfer is not None:
                self.transfer.close()
        finally:
            if self.paged:
                self.executor.close()
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
