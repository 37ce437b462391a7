"""Low-overhead span tracer (monotonic clock, ring buffer, thread-safe): the
port's copy of the JAX package's ``obs/tracer.py``.

Design constraints, in order:

1. **Never perturb the engine.**  Every emit is one tuple allocation plus
   one lock-protected ring-slot write — no I/O, no allocation growth, no
   blocking.  When the ring is full the OLDEST event is overwritten (and
   counted in :attr:`SpanTracer.dropped`); the engine thread never waits.
   Call sites guard on ``tracer is not None`` so the untraced path runs
   the exact same computation (bitwise-identical outputs on/off).
2. **Timestamps are ``time.perf_counter()``** — the same monotonic clock
   every :class:`EngineStats` window uses, so :mod:`repro_torch.obs.reconcile`
   can recompute the overlap accounting from spans without clock skew.
3. **Thread-safe by a single lock**: spans arrive from the engine thread,
   the planner thread, the executor's host-lane threads, and the transfer
   engine's per-direction copy workers.  Each logical timeline gets its
   own *track* (one Perfetto thread row), and within one track spans are
   emitted by a single thread at a time, so per-track spans nest or are
   disjoint — a property the well-formedness tests assert.

Event model (one namedtuple per ring slot):

* ``ph="X"`` — complete span ``[t0, t1]`` on ``track``.
* ``ph="i"`` — instant on ``track``.
* ``ph="C"`` — counter sample (``args`` = {series: value}).
* ``ph="b"/"e"/"n"`` — async begin/end/instant keyed by ``rid`` (request
  lifecycle spans; rendered as one async row per request id).

Export:

* :meth:`SpanTracer.export_chrome` — Chrome trace-event JSON.  Loadable
  in Perfetto / ``chrome://tracing``: one named thread row per track,
  counter tracks, and request lifecycles as async events.
* :meth:`SpanTracer.export_counters_jsonl` — the counter time-series as
  one JSON object per line (a cheap sink for dashboards / pandas).
"""

from __future__ import annotations

import json
import threading
import time
from collections import namedtuple
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

SpanEvent = namedtuple("SpanEvent", ["ph", "track", "name", "t0", "t1", "rid", "args"])

# preferred Perfetto row order (everything else: first-seen order after these)
_TRACK_ORDER = ("engine", "planner", "sched", "device")


class SpanTracer:
    """Thread-safe monotonic-clock span recorder over a fixed ring buffer."""

    def __init__(self, capacity: int = 65536):
        if capacity <= 0:
            raise ValueError("SpanTracer capacity must be positive")
        self.capacity = int(capacity)
        self._buf: List[Optional[SpanEvent]] = [None] * self.capacity
        self._n = 0  # total events ever emitted
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # emission (hot path)
    # ------------------------------------------------------------------
    def _push(self, ev: SpanEvent) -> None:
        with self._lock:
            self._buf[self._n % self.capacity] = ev
            self._n += 1

    def emit(self, track: str, name: str, t0: float, t1: float,
             args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete span ``[t0, t1]`` (perf_counter stamps)."""
        self._push(SpanEvent("X", track, name, t0, t1, None, args))

    @contextmanager
    def span(self, track: str, name: str,
             args: Optional[Dict[str, Any]] = None) -> Iterator[Dict[str, Any]]:
        """Context-managed span; yields the (mutable) args dict."""
        a = {} if args is None else args
        t0 = time.perf_counter()
        try:
            yield a
        finally:
            self.emit(track, name, t0, time.perf_counter(), a)

    def instant(self, track: str, name: str,
                args: Optional[Dict[str, Any]] = None,
                t: Optional[float] = None) -> None:
        t = time.perf_counter() if t is None else t
        self._push(SpanEvent("i", track, name, t, t, None, args))

    def counter(self, name: str, values: Dict[str, Any],
                t: Optional[float] = None) -> None:
        """Record one sample of a multi-series counter track."""
        t = time.perf_counter() if t is None else t
        self._push(SpanEvent("C", "counters", name, t, t, None, dict(values)))

    # -- request lifecycle (async events keyed by rid) -------------------
    def async_begin(self, rid: int, name: str, t: Optional[float] = None,
                    args: Optional[Dict[str, Any]] = None) -> None:
        t = time.perf_counter() if t is None else t
        self._push(SpanEvent("b", "request", name, t, t, rid, args))

    def async_end(self, rid: int, name: str, t: Optional[float] = None,
                  args: Optional[Dict[str, Any]] = None) -> None:
        t = time.perf_counter() if t is None else t
        self._push(SpanEvent("e", "request", name, t, t, rid, args))

    def async_instant(self, rid: int, name: str, t: Optional[float] = None,
                      args: Optional[Dict[str, Any]] = None) -> None:
        t = time.perf_counter() if t is None else t
        self._push(SpanEvent("n", "request", name, t, t, rid, args))

    # ------------------------------------------------------------------
    # inspection
    # ------------------------------------------------------------------
    @property
    def total(self) -> int:
        """Events ever emitted (including overwritten ones)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Oldest events overwritten by ring wrap-around."""
        return max(0, self._n - self.capacity)

    def events(self) -> List[SpanEvent]:
        """Surviving events in emission order (oldest first)."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return [e for e in self._buf[:n]]
            head = n % cap
            return self._buf[head:] + self._buf[:head]  # type: ignore[return-value]

    def tracks(self) -> List[str]:
        """Distinct span/instant tracks, in preferred display order."""
        seen: List[str] = []
        for e in self.events():
            if e.ph in ("X", "i") and e.track not in seen:
                seen.append(e.track)
        pri = {t: i for i, t in enumerate(_TRACK_ORDER)}
        return sorted(seen, key=lambda t: (pri.get(t, len(_TRACK_ORDER)), t))

    # ------------------------------------------------------------------
    # sinks
    # ------------------------------------------------------------------
    def export_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto-loadable).

        One named thread row per track (pid 1, "neo-engine"), counter
        tracks from :meth:`counter` samples, and request lifecycle spans
        as async ("b"/"e"/"n") events grouped by request id.  Timestamps
        are perf_counter seconds scaled to microseconds.
        """
        events = self.events()
        tids = {t: i + 1 for i, t in enumerate(self.tracks())}
        out: List[Dict[str, Any]] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "neo-engine"}},
        ]
        for track, tid in tids.items():
            out.append({"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                        "args": {"name": track}})
            out.append({"ph": "M", "pid": 1, "tid": tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": tid}})
        for e in events:
            ts = e.t0 * 1e6
            if e.ph == "X":
                # both stamps are scaled first and then subtracted: two
                # perf_counter values within a factor of 2 of each other
                # subtract exactly (Sterbenz), so ts + dur == t1 * 1e6 and a
                # span and its nested span that end on one float end on one
                # microsecond value too
                ev = {"ph": "X", "pid": 1, "tid": tids[e.track], "name": e.name,
                      "cat": e.track, "ts": ts, "dur": e.t1 * 1e6 - ts}
            elif e.ph == "i":
                ev = {"ph": "i", "pid": 1, "tid": tids[e.track], "name": e.name,
                      "cat": e.track, "ts": ts, "s": "t"}
            elif e.ph == "C":
                ev = {"ph": "C", "pid": 1, "name": e.name, "ts": ts,
                      "args": dict(e.args or {})}
                out.append(ev)
                continue  # counter args ARE the payload; skip the args merge
            else:  # async request lifecycle
                ev = {"ph": e.ph, "pid": 1, "tid": 0, "name": e.name,
                      "cat": "request", "id": str(e.rid), "ts": ts}
            if e.args:
                ev["args"] = dict(e.args)
            out.append(ev)
        trace = {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "tracer": "repro_torch.obs",
                "events_recorded": self.total,
                "events_dropped": self.dropped,
            },
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    def export_counters_jsonl(self, path: str) -> int:
        """Write the counter time-series (one ``{"t", "name", "values"}``
        object per line); returns the number of samples written."""
        n = 0
        with open(path, "w") as f:
            for e in self.events():
                if e.ph != "C":
                    continue
                f.write(json.dumps({"t": e.t0, "name": e.name,
                                    "values": e.args}) + "\n")
                n += 1
        return n
