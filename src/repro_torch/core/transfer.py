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
reference's runs on the caller's thread.  The per-shard streams of tensor
parallelism are not ported (ROADMAP P13).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

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
    # per-stream copy time ("out" / "in"); the two streams overlap, so the
    # sum may exceed wall time
    busy_by_stream: Dict[str, float] = field(default_factory=dict)
    wait_time: float = 0.0  # time join() callers spent blocked


class TransferHandle:
    """Future for one queued request-swap; join before touching the pages."""

    def __init__(self, kind: str, req: Request, nbytes: int):
        self.kind = kind  # "out" | "in"
        self.req = req
        self.nbytes = nbytes
        # engine iteration that launched this swap (tracing: pairs the
        # worker's copy span with that iteration's dispatch window)
        self.trace_iter = 0
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self._apply: Optional[Callable[[], None]] = None  # staged device write
        self._joined = False
        # the CUDA event recorded after this swap's PCIe copy (None on the CPU)
        self.cuda_event: Optional["torch.cuda.Event"] = None
        # copy window stamped by the worker: the engine intersects it with
        # its dispatch window to count bytes hidden under compute
        self.copy_start: float = 0.0
        self.copy_end: float = 0.0

    def hidden_bytes(self, window_start: float, window_end: float) -> int:
        """Bytes of this swap hidden under [start, end]: ``int(nbytes *
        fraction)`` of the copy window overlapped, as the reference counts
        a single-job swap."""
        dur = self.copy_end - self.copy_start
        if dur <= 0:
            return 0
        ov = min(self.copy_end, window_end) - max(self.copy_start, window_start)
        return int(self.nbytes * max(0.0, min(1.0, ov / dur)))

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


@dataclass
class _Job:
    handle: TransferHandle
    fn: Callable[[], None]


class TransferEngine:
    """Copy streams executing page-granular KV moves between the pools.

    ``compute_stream`` is the stream the engine's device lane runs on (the
    current stream at launch when None); swap-outs order their gathers
    against it.
    """

    def __init__(self, pool: DualPool, *,
                 compute_stream: Optional["torch.cuda.Stream"] = None):
        self.pool = pool
        self.stats = TransferStats()
        self._lock = threading.Lock()
        # tracing (repro_torch.obs): set by the engine; each worker emits one
        # copy span per job on its stream's track
        self.tracer = None
        self.trace_iter = 0
        self.compute_stream = compute_stream
        dev = pool.device.k.device
        streams = ("out", "in")  # one copy stream and worker per PCIe direction
        self._copy_streams = {s: new_stream(dev) for s in streams}
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

    def _compute(self) -> Optional["torch.cuda.Stream"]:
        if self.pool.device.k.device.type != "cuda":
            return None
        return self.compute_stream or torch.cuda.current_stream(self.pool.device.k.device)

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
                h.copy_start, h.copy_end = t0, t1
            tr = self.tracer
            if tr is not None:
                # emitted BEFORE the event fires, so the span exists by the
                # time any join on this handle returns
                tr.emit(f"copy-{stream}", h.kind, t0, t1,
                        {"nbytes": h.nbytes, "iter": h.trace_iter})
            h._event.set()

    # ------------------------------------------------------------------
    # launch (engine thread)
    # ------------------------------------------------------------------
    def swap_out(self, req: Request) -> TransferHandle:
        """Device -> host.  Pages/location move now; data moves behind."""
        self._ensure_open()
        dev, host = self.pool.device, self.pool.host
        if not req.pages:
            req.location = "cpu"
            h = TransferHandle("out", req, 0)
            h._event.set()
            return h
        compute = self._compute()
        cs = self._copy_streams["out"]
        # the read of the pool is a gather on the compute stream (cast to the
        # host dtype on the card): after every queued write to these pages,
        # before any later kernel that writes the pages freed below
        with on_stream(compute):
            k_dev, v_dev = dev.gather(req.pages, host.dtype)
        if cs is not None:
            cs.wait_stream(compute)  # an event recorded after the gather
            k_dev.record_stream(cs)  # the staging outlives its copy below
            v_dev.record_stream(cs)
        k_h, _ = copy_async(k_dev, host.k.device, cs)
        v_h, ev_v = copy_async(v_dev, host.k.device, cs)
        new_pages = host.alloc(len(req.pages))
        dev.free(req.pages)
        req.pages = new_pages
        req.location = "cpu"
        nbytes = k_h.numel() * k_h.element_size() + v_h.numel() * v_h.element_size()
        handle = TransferHandle("out", req, nbytes)
        handle.trace_iter = self.trace_iter
        handle.cuda_event = ev_v  # recorded after both copies on one stream

        def copy() -> None:  # copy-stream worker
            if ev_v is not None:
                ev_v.synchronize()  # the staging landed in pinned memory
            host.scatter(new_pages, k_h, v_h)
            with self._lock:
                self.stats.bytes_out += nbytes
            self.pool.add_swap_bytes(nbytes)

        self._enqueue("out", handle, copy)
        return handle

    def swap_in(self, req: Request) -> TransferHandle:
        """Host -> device.  The in worker gathers the host pages into pinned
        staging and copies it to the card; the host pages return to the free
        list and the device pages are written at join time on the engine
        thread."""
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
        handle = TransferHandle("in", req, nbytes)
        handle.trace_iter = self.trace_iter
        staged: Dict[str, object] = {}
        device = dev.k.device

        def gather() -> None:  # copy-stream worker, on the in stream
            k_h, v_h = host.gather(old_pages)
            stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
            staged["k"], _ = copy_async(k_h, device, stream)
            staged["v"], ev = copy_async(v_h, device, stream)
            if ev is not None:
                handle.cuda_event = ev
                ev.synchronize()
            with self._lock:
                self.stats.bytes_in += nbytes
            self.pool.add_swap_bytes(nbytes)

        def apply() -> None:  # engine thread, at join: the device-pool write
            host.free(old_pages)
            k, v = staged["k"], staged["v"]
            if handle.cuda_event is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(handle.cuda_event)
                k.record_stream(cur)  # the staging outlives this scatter
                v.record_stream(cur)
            dev.scatter(new_pages, k, v)

        handle._apply = apply
        self._enqueue("in", handle, gather)
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

    def _enqueue(self, kind: str, handle: TransferHandle, fn: Callable[[], None]) -> None:
        with self._lock:
            self._pending.append(handle)
        self._queues[kind].put(_Job(handle, fn))

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
                if h.cuda_event is not None:
                    h.cuda_event.synchronize()
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
