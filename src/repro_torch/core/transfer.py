"""Asynchronous KV transfer engine (the PCIe DMA stage of Fig. 5), the
port of the JAX package's ``core/transfer.py``.

The pipelined engine overlaps KV swaps with compute through a
**launch → join** protocol:

* :meth:`TransferEngine.swap_out` / :meth:`swap_in` are called in the
  engine's LAUNCH phase.  They move the free-page accounting and the
  request's ``pages``/``location`` synchronously — so the scheduler's view is
  the serial path's — and start the data movement behind it.
* The returned :class:`TransferHandle` is joined right before the pages are
  touched, and joins are LANE-SCOPED: each host-lane thread joins only the
  swap-outs of the rows it decodes (:meth:`join_requests`), the engine joins
  swap-ins before the device lane reads the pool, and :meth:`drain` joins the
  rest at the end of the step.

Copies run per PCIe direction — one CUDA copy stream and one worker thread
for device→host, one for host→device, so a swap-out burst never queues
behind swap-ins.  The worker stamps each copy's wall-time window, so the engine counts the bytes hidden under
compute as the reference does.

Unlike the reference's immutable jax arrays, the torch pools are written in
place, so the reference's "device reads are snapshotted at submit time"
argument is replaced by stream ordering:

* **device→host** (:meth:`swap_out`): at launch, on the engine thread, the
  request's pages are gathered into a device staging tensor (cast to the
  host pool's dtype on the card) on the compute stream itself, so the read
  comes after every queued write to the pages and before any later kernel
  that writes the device pages freed at launch (a prefill or a new token
  given the same page).  The out stream waits for an event recorded on the
  compute stream after the gather and copies the staging into pinned
  memory, recording an event after the copy; that PCIe copy overlaps the
  compute stream, which never waits for it.  The out worker
  waits for the copy's event, then scatters the staging into the host pool.
* **host→device** (:meth:`swap_in`): the in worker gathers the host pages
  into pinned staging and copies it to the card on the in stream, waiting
  for the copy's event; the host pages are freed and the device pages
  written at join time on the engine thread, on the compute stream after it
  waited for that event.
* A join waits for the worker's job (a Python event) and then for the job's
  CUDA event, so host attention never reads pinned pages a copy has not
  landed in.

Thread-safety contract (the reference's): ``swap_out``/``swap_in`` and any
join that applies a staged device write (joining swap-ins) run on the
engine thread; joining swap-outs is safe from any thread.  Every wait takes
a timeout.  The prefix cache's :meth:`TransferEngine.copy_pages` runs
synchronously on the engine thread and the compute stream, as the
reference's runs on the caller's thread.

Under tensor parallelism (``shards > 1``) every swap fans out into one job
per shard per direction, on streams ``out0``/``out1``/``in0``/…, each with
a copy stream on its shard's device and a worker of its own: each job moves
its shard's KV-head slice of the pages between the host pool and that
shard's device pool (or that slice of an unsharded device pool).  The
slices partition the pages, so the per-shard bytes sum exactly to the
one-shard totals (``TransferStats.bytes_by_stream`` records the split); a
handle's event fires when its last shard's job lands, a swap-in's device
write waits for every shard's copy, and ``hidden_bytes`` sums the jobs'
spans as ``obs.reconcile`` does.  ``copy_pages`` copies every shard.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.core.kv_cache import DualPool, copy_async
from repro_torch.core.request import Request
from repro_torch.device import new_stream, on_stream

# Longest any join or shutdown waits before it raises: a full-width host
# lane or copy takes seconds at most, so this only ever ends a hang.
WAIT_TIMEOUT_S = 600.0


@dataclass
class TransferStats:
    """Aggregate accounting (lock-protected inside the engine)."""

    jobs: int = 0
    bytes_out: int = 0  # device -> host
    bytes_in: int = 0  # host -> device
    busy_time: float = 0.0  # summed worker wall time spent copying
    # per-stream copy time ("out" / "in"; "out0" / "in1" / ... per shard
    # under TP); the streams overlap, so the sum may exceed wall time
    busy_by_stream: Dict[str, float] = field(default_factory=dict)
    # per-stream bytes moved: under TP the per-shard split of every swap
    bytes_by_stream: Dict[str, int] = field(default_factory=dict)
    wait_time: float = 0.0  # time join() callers spent blocked


class TransferHandle:
    """Future for one queued request-swap; join before touching the pages.
    It spans every copy job of the swap (one per shard under TP); its event
    fires when the last one lands."""

    def __init__(self, kind: str, req: Request, nbytes: int):
        self.kind = kind  # "out" | "in"
        self.req = req
        self.nbytes = nbytes  # all jobs together
        # engine iteration that launched this swap (tracing: pairs the
        # worker's copy span with that iteration's dispatch window)
        self.trace_iter = 0
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self._apply: Optional[Callable[[], None]] = None  # staged device write
        self._joined = False
        # the CUDA events recorded after this swap's PCIe copies (none on
        # the CPU)
        self.cuda_events: List["torch.cuda.Event"] = []
        # copy window stamped by the workers (the union of the jobs'): the
        # engine intersects the jobs' windows with its dispatch window to
        # count bytes hidden under compute
        self.copy_start: float = 0.0
        self.copy_end: float = 0.0
        self._jobs_total = 1
        self._jobs_done = 0
        self._job_spans: List[Tuple[int, float, float]] = []  # (nbytes, t0, t1)

    def hidden_bytes(self, window_start: float, window_end: float) -> int:
        """Bytes of this swap hidden under [start, end], summed per job:
        ``int(nbytes * fraction)`` of each job's copy window overlapped, the
        truncation ``obs.reconcile`` applies to each copy span."""
        total = 0
        for nb, t0, t1 in self._job_spans:
            dur = t1 - t0
            if dur <= 0:
                continue
            ov = min(t1, window_end) - max(t0, window_start)
            total += int(nb * max(0.0, min(1.0, ov / dur)))
        return total

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


@dataclass
class _Job:
    handle: TransferHandle
    fn: Callable[[], None]
    nbytes: int  # this job's share of the handle's bytes


class TransferEngine:
    """Copy streams executing page-granular KV moves between the pools.

    ``compute_stream`` is the stream the engine's device lane runs on (the
    current stream at launch when None); swap-outs order their gathers
    against it.  ``shards`` (tensor parallelism) must divide the KV heads.
    """

    def __init__(self, pool: DualPool, *,
                 compute_stream: Optional["torch.cuda.Stream"] = None, shards: int = 1):
        self.pool = pool
        self.stats = TransferStats()
        self._lock = threading.Lock()
        # tracing (repro_torch.obs): set by the engine; each worker emits one
        # copy span per job on its stream's track
        self.tracer = None
        self.trace_iter = 0
        self.compute_stream = compute_stream
        self.shards = max(1, int(shards))
        kv_heads = pool.host.k.shape[3]
        if self.shards > 1 and kv_heads % self.shards:
            raise ValueError(f"shards={self.shards} must divide the pool's "
                             f"{kv_heads} kv head(s)")
        if pool.device.num_shards not in (1, self.shards):
            raise ValueError(f"shards={self.shards} for a device pool sharded "
                             f"{pool.device.num_shards} ways")
        # one copy stream and worker per PCIe direction, per shard under TP,
        # each on its shard's device
        self._parts: List[Optional[Tuple[int, int]]] = (
            [None] if self.shards == 1 else [(s, self.shards) for s in range(self.shards)])
        self._copy_streams = {self._stream(kind, p): new_stream(pool.device.part_device(p))
                              for kind in ("out", "in") for p in self._parts}
        streams = list(self._copy_streams)
        self._queues: Dict[str, "queue.Queue[Optional[_Job]]"] = {
            s: queue.Queue() for s in streams}
        self._pending: List[TransferHandle] = []
        self._closed = False
        self._workers = {
            s: threading.Thread(target=self._run, args=(s,),
                                name=f"neo-transfer-{s}", daemon=True)
            for s in streams}
        for w in self._workers.values():
            w.start()

    @staticmethod
    def _stream(kind: str, part: Optional[Tuple[int, int]]) -> str:
        return kind if part is None else f"{kind}{part[0]}"

    def _compute(self) -> Optional["torch.cuda.Stream"]:
        dev = self.pool.device.devices[0]
        if dev.type != "cuda":
            return None
        return self.compute_stream or torch.cuda.current_stream(dev)

    # ------------------------------------------------------------------
    # workers (one per copy stream)
    # ------------------------------------------------------------------
    def _run(self, stream: str) -> None:
        q = self._queues[stream]
        while True:
            job = q.get()
            if job is None:
                return
            h = job.handle
            if self._closed:
                # enqueued against a closed engine: skip the copy (its pages
                # may be retired) but complete the handle so no joiner hangs
                if h.error is None:
                    h.error = RuntimeError("transfer job enqueued after close()")
                with self._lock:
                    h._jobs_done += 1
                    last = h._jobs_done >= h._jobs_total
                if last:
                    h._event.set()
                continue
            t0 = time.perf_counter()
            failed = False
            try:
                with on_stream(self._copy_streams[stream]):
                    job.fn()
            except BaseException as e:  # surfaced at join
                h.error = e
                failed = True
            t1 = time.perf_counter()
            with self._lock:
                self.stats.jobs += 1
                self.stats.busy_time += t1 - t0
                self.stats.busy_by_stream[stream] = (
                    self.stats.busy_by_stream.get(stream, 0.0) + (t1 - t0))
                if not failed:
                    self.stats.bytes_by_stream[stream] = (
                        self.stats.bytes_by_stream.get(stream, 0) + job.nbytes)
                    first = not h._job_spans
                    h.copy_start = t0 if first else min(h.copy_start, t0)
                    h.copy_end = t1 if first else max(h.copy_end, t1)
                    h._job_spans.append((job.nbytes, t0, t1))
                h._jobs_done += 1
                last = h._jobs_done >= h._jobs_total
            tr = self.tracer
            if tr is not None:
                # emitted BEFORE the event fires, so the span exists by the
                # time any join on this handle returns
                tr.emit(f"copy-{stream}", h.kind, t0, t1,
                        {"nbytes": job.nbytes, "iter": h.trace_iter})
            if last:
                h._event.set()

    # ------------------------------------------------------------------
    # launch (engine thread)
    # ------------------------------------------------------------------
    def swap_out(self, req: Request) -> TransferHandle:
        """Device -> host.  Pages/location move now; data moves behind, one
        job per shard."""
        self._ensure_open()
        dev, host = self.pool.device, self.pool.host
        if not req.pages:
            req.location = "cpu"
            h = TransferHandle("out", req, 0)
            h._event.set()
            return h
        compute = self._compute()
        # the read of the pool is a gather on the compute stream (cast to the
        # host dtype on the card): after every queued write to these pages,
        # before any later kernel that writes the pages freed below
        jobs = []
        for part in self._parts:
            cs = self._copy_streams[self._stream("out", part)]
            with on_stream(compute):
                k_dev, v_dev = dev.gather(req.pages, host.dtype, part)
                src = torch.cuda.current_stream(k_dev.device) if cs is not None else None
            if cs is not None:
                cs.wait_stream(src)  # an event recorded after the gather
                k_dev.record_stream(cs)  # the staging outlives its copy below
                v_dev.record_stream(cs)
            k_h, _ = copy_async(k_dev, host.k.device, cs)
            v_h, ev_v = copy_async(v_dev, host.k.device, cs)  # after both copies
            jobs.append((part, k_h, v_h, ev_v))
        new_pages = host.alloc(len(req.pages))
        dev.free(req.pages)
        req.pages = new_pages
        req.location = "cpu"
        sizes = [k.numel() * k.element_size() + v.numel() * v.element_size()
                 for _, k, v, _ in jobs]
        handle = TransferHandle("out", req, sum(sizes))
        handle.trace_iter = self.trace_iter
        handle.cuda_events = [ev for *_, ev in jobs if ev is not None]

        def copy(part, k_h, v_h, ev_v, nb) -> None:  # repro-role: copy-stream
            if ev_v is not None:
                ev_v.synchronize()  # the staging landed in pinned memory
            host.scatter(new_pages, k_h, v_h, part)
            with self._lock:
                self.stats.bytes_out += nb
            self.pool.add_swap_bytes(nb)

        self._enqueue(handle, [(self._stream("out", job[0]), functools.partial(copy, *job, nb), nb)
                               for job, nb in zip(jobs, sizes)])
        return handle

    def swap_in(self, req: Request) -> TransferHandle:
        """Host -> device.  The in workers (one per shard) gather the host
        pages into pinned staging and copy it to the card; the host pages
        return to the free list and the device pages are written at join
        time on the engine thread, once every shard's copy has landed."""
        self._ensure_open()
        dev, host = self.pool.device, self.pool.host
        if not req.pages:
            req.location = "gpu"
            h = TransferHandle("in", req, 0)
            h._event.set()
            return h
        old_pages = req.pages
        new_pages = dev.alloc(len(req.pages))
        req.pages = new_pages
        req.location = "gpu"
        page_bytes = host.k[:, :1].numel() * host.k.element_size()
        nbytes = 2 * page_bytes * len(old_pages)
        nb = nbytes // len(self._parts)  # exact: the slices partition the pages
        handle = TransferHandle("in", req, nbytes)
        handle.trace_iter = self.trace_iter
        staged: Dict[Optional[Tuple[int, int]], Tuple[torch.Tensor, torch.Tensor]] = {}
        events: Dict[Optional[Tuple[int, int]], "torch.cuda.Event"] = {}

        def gather(part) -> None:  # repro-role: copy-stream -- the part's in stream
            k_h, v_h = host.gather(old_pages, shard=part)
            device = dev.part_device(part)
            stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
            k, _ = copy_async(k_h, device, stream)
            v, ev = copy_async(v_h, device, stream)
            if ev is not None:
                events[part] = ev
                ev.synchronize()
            staged[part] = (k, v)
            with self._lock:
                self.stats.bytes_in += nb
            self.pool.add_swap_bytes(nb)

        def apply() -> None:  # repro-role: engine -- runs at join time: the device-pool write
            host.free(old_pages)
            for part in self._parts:
                k, v = staged[part]
                ev = events.get(part)
                if ev is not None:
                    cur = torch.cuda.current_stream(k.device)
                    cur.wait_event(ev)
                    k.record_stream(cur)  # the staging outlives this scatter
                    v.record_stream(cur)
                dev.scatter(new_pages, k, v, part)

        handle._apply = apply
        self._enqueue(handle, [(self._stream("in", part), functools.partial(gather, part), nb)
                               for part in self._parts])
        return handle

    # ------------------------------------------------------------------
    # page-granular copies (prefix cache: promote / demote / COW)
    # ------------------------------------------------------------------
    def copy_pages(self, pages: List[int], src: str, dst: str) -> List[int]:
        """Copy ``pages`` from the ``src`` pool into freshly allocated pages
        of the ``dst`` pool ("gpu" | "cpu"); returns the new page ids.

        Runs synchronously on the engine thread, on the compute stream, with
        the PCIe byte accounting of the swaps at the host pool's width.  A
        device read comes after every write queued on the compute stream (a
        prefill that just filled the page) and before any later kernel that
        writes a page freed after it; the stream is synchronised before the
        call returns, so a host page it wrote is complete.  The source pages
        are left untouched: the prefix cache releases them with refcounted
        ``free`` where it must."""
        self._ensure_open()
        if not pages:
            return []
        src_pool, dst_pool = self.pool.pool(src), self.pool.pool(dst)
        tr = self.tracer
        t0c = time.perf_counter() if tr is not None else 0.0
        compute = self._compute()
        with on_stream(compute):
            k, v = src_pool.read_pages(pages)
            new_pages = dst_pool.alloc(len(pages))
            dst_pool.put_pages(new_pages, k, v)
            if compute is not None:
                compute.synchronize()
        nbytes = 0
        if src != dst:  # a PCIe crossing
            host = self.pool.host
            nbytes = 2 * host.k[:, :1].numel() * host.k.element_size() * len(pages)
            with self._lock:
                if dst == "cpu":
                    self.stats.bytes_out += nbytes
                else:
                    self.stats.bytes_in += nbytes
            self.pool.add_swap_bytes(nbytes)
        if tr is not None:
            tr.emit("copy-sync", f"{src}->{dst}", t0c, time.perf_counter(),
                    {"pages": len(pages), "nbytes": nbytes})
        return new_pages

    def _enqueue(self, handle: TransferHandle,
                 jobs: List[Tuple[str, Callable[[], None], int]]) -> None:
        """Register ``handle`` as pending, then queue its ``jobs``
        [(stream, fn, nbytes)], one per shard."""
        handle._jobs_total = len(jobs)
        with self._lock:
            self._pending.append(handle)
        for stream, fn, nb in jobs:
            self._queues[stream].put(_Job(handle, fn, nb))

    # ------------------------------------------------------------------
    # join
    # ------------------------------------------------------------------
    def join(self, handles: Iterable[TransferHandle],
             timeout: float = WAIT_TIMEOUT_S) -> None:
        """Block until the given transfers are complete and safe to use.

        Swap-in handles apply their staged device write here — join
        swap-ins from the engine thread only.  Time spent blocked is
        accounted in ``stats.wait_time``; a transfer still running after
        ``timeout`` seconds raises TimeoutError.
        """
        t0 = time.perf_counter()
        try:
            for h in handles:
                if not h._event.wait(timeout):
                    raise TimeoutError(f"swap-{h.kind} of request {h.req.rid} did not "
                                       f"finish within {timeout:.0f} s")
                with self._lock:
                    h._joined = True  # consumed even on error
                    apply, h._apply = h._apply, None
                if h.error is not None:
                    raise h.error
                for ev in h.cuda_events:
                    ev.synchronize()
                if apply is not None:
                    apply()
        finally:
            with self._lock:
                self.stats.wait_time += time.perf_counter() - t0
                self._pending = [p for p in self._pending if not p._joined]

    def join_requests(self, reqs: Iterable[Request], kind: Optional[str] = None) -> None:
        """Lane-scoped join: every pending transfer whose request is in
        ``reqs`` (optionally only ``kind`` "out" / "in").  Only call with
        swap-ins from the engine thread."""
        rids = {r.rid for r in reqs}
        with self._lock:
            hs = [h for h in self._pending
                  if h.req.rid in rids and (kind is None or h.kind == kind)]
        self.join(hs)

    def drain(self) -> None:
        """Join every outstanding transfer (step barrier / shutdown)."""
        with self._lock:
            hs = list(self._pending)
        self.join(hs)

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent shutdown: drain every outstanding transfer, stop the
        workers with queue sentinels and join them with a timeout.  A
        transfer that failed in flight is re-raised only after every worker
        has been joined; after close, swap_out/swap_in raise."""
        if self._closed:
            return
        errors: List[BaseException] = []
        while True:  # each failed round consumes its handle, so this ends
            try:
                self.drain()
                break
            except BaseException as e:
                errors.append(e)
        self._closed = True
        for q in self._queues.values():
            q.put(None)
        for s, w in self._workers.items():
            w.join(timeout=timeout)
            if w.is_alive():
                errors.append(RuntimeError(
                    f"copy-stream worker {s!r} did not exit within {timeout:.1f}s "
                    "of its shutdown sentinel"))
        if errors:
            raise errors[0]

    def _ensure_open(self) -> None:
        if self._closed:
            raise RuntimeError("TransferEngine is closed")
