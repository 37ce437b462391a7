"""Reconcile the span timeline against :class:`EngineStats` (the port's copy
of the JAX package's ``obs/reconcile.py``, same checks and tolerances).

:func:`reconcile` recomputes the engine's overlap accounting **from the
spans alone** — per-lane busy time, realized/ideal pipeline overlap,
bubble fraction, swap bytes hidden under compute, and plan-ahead hidden
time — using the exact same formulas ``NeoEngine._step_paged`` applies
to its live windows, then asserts agreement with the counters the engine
accumulated.  A divergence means either the instrumentation or the
accounting drifted: the trace is a standing audit of the numbers every
perf gate (bubble_fraction, planahead gates, swap-hidden trends) depends
on.

Span contract consumed here (emitted by the engine/executor/transfer
instrumentation; all timestamps are shared-clock ``perf_counter``):

* ``device`` track — ``prefill`` / ``batch0`` / ``serial`` dispatch
  windows, ``args.iter`` = iteration id.
* ``host<li>`` tracks — one ``lane`` span per executed host lane per
  iteration; inline lanes carry ``args.inline=True`` and
  ``args.host_busy`` (the serialized-step hideable-half input).
* ``engine`` track — ``dispatch`` (the hidden-bytes window
  ``[dispatch_t0, win_end]``), ``plan_fresh`` (``args.dur``,
  ``args.hideable``), ``plan_harvest`` (``args.dur``) and the
  ``plan_adopt`` instant (``args.dur`` = planner time hidden under the
  previous iteration's lanes).
* ``copy-out`` / ``copy-in`` / ``copy-all`` tracks — one span per
  async copy job with ``args.nbytes`` and ``args.iter``.

The ``spec`` track (batched draft-verification passes) is deliberately
OUTSIDE this audit, like ``copy-sync``: verify wall time accrues only to
``EngineStats.spec_busy_time`` and never enters the lane busy / overlap
/ bubble formulas recomputed here, so speculation cannot perturb the
audited numbers by construction (see ``docs/spec_decode.md``).

The pass refuses to certify a wrapped ring (``tracer.dropped > 0``): a
truncated timeline cannot audit cumulative counters.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

from repro_torch.obs.tracer import SpanEvent, SpanTracer

_HOST_LANE = re.compile(r"^host(\d+)$")
# prefixes: TP shards emit per-shard streams ("copy-out0", "copy-in1", ...);
# the bare names are the single-shard streams.  "copy-sync" deliberately
# does NOT match — synchronous page copies never overlap a dispatch window.
_COPY_TRACKS = ("copy-out", "copy-in", "copy-all")


@dataclass
class ReconcileReport:
    ok: bool = True
    dropped: int = 0
    checks: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    def add(self, name: str, stat: Any, traced: Any, ok: bool) -> None:
        self.checks[name] = {"stats": stat, "traced": traced, "ok": bool(ok)}
        if not ok:
            self.ok = False

    def failed(self) -> List[str]:
        return [k for k, v in self.checks.items() if not v["ok"]]

    def summary(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "dropped": self.dropped,
            "failed": self.failed(),
            "checks": self.checks,
            "notes": self.notes,
        }


def _close(a: float, b: float, rtol: float, atol: float) -> bool:
    return abs(a - b) <= atol + rtol * max(abs(a), abs(b))


def _union(windows: List[Tuple[float, float]]) -> float:
    """Merged-interval union length — the exact engine computation."""
    merged = sorted(windows)
    union = 0.0
    cur_s, cur_e = merged[0]
    for s, e in merged[1:]:
        if s > cur_e:
            union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    union += cur_e - cur_s
    return union


def _hidden_fraction(t0: float, t1: float, w0: float, w1: float) -> float:
    """Replicates :meth:`TransferHandle.hidden_fraction` bit for bit."""
    dur = t1 - t0
    if dur <= 0:
        return 0.0
    ov = min(t1, w1) - max(t0, w0)
    return max(0.0, min(1.0, ov / dur))


def reconcile(tracer: SpanTracer, stats, *, rtol: float = 1e-6,
              atol: float = 1e-6) -> ReconcileReport:
    """Recompute lane busy / overlap / bubble / hidden bytes / plan time
    from ``tracer``'s spans and compare against ``stats``
    (:class:`~repro_torch.core.engine.EngineStats`).  Time checks use
    ``atol + rtol * max(|a|, |b|)``; byte counters must match exactly."""
    rep = ReconcileReport(dropped=tracer.dropped)
    if tracer.dropped > 0:
        rep.ok = False
        rep.notes.append(
            f"ring dropped {tracer.dropped} events: cumulative counters "
            "cannot be audited from a truncated timeline")
        return rep
    events = tracer.events()

    # ---- bucket the spans the audit consumes -------------------------
    lane_busy: Dict[str, float] = {}
    dev_by_iter: Dict[int, List[Tuple[float, float]]] = {}
    lanes_by_iter: Dict[int, List[SpanEvent]] = {}
    dispatch_by_iter: Dict[int, Tuple[float, float]] = {}
    copies: List[SpanEvent] = []
    plan_busy = 0.0
    hideable_plan = 0.0
    adopt_durs: List[float] = []

    for e in events:
        if e.ph == "X" and e.track == "device":
            lane_busy[e.name] = lane_busy.get(e.name, 0.0) + (e.t1 - e.t0)
            it = (e.args or {}).get("iter")
            if it is not None:
                dev_by_iter.setdefault(it, []).append((e.t0, e.t1))
        elif e.ph == "X" and _HOST_LANE.match(e.track) and e.name == "lane":
            lane_busy[e.track] = lane_busy.get(e.track, 0.0) + (e.t1 - e.t0)
            it = (e.args or {}).get("iter")
            if it is not None:
                lanes_by_iter.setdefault(it, []).append(e)
        elif e.ph == "X" and e.track == "engine" and e.name == "dispatch":
            dispatch_by_iter[(e.args or {})["iter"]] = (e.t0, e.t1)
        elif e.ph == "X" and e.track.startswith(_COPY_TRACKS):
            copies.append(e)
        elif e.ph == "X" and e.track == "engine" and e.name in (
                "plan_fresh", "plan_harvest"):
            plan_busy += e.args["dur"]
            if e.name == "plan_fresh" and e.args.get("hideable"):
                hideable_plan += e.args["dur"]
        elif e.ph == "i" and e.track == "engine" and e.name == "plan_adopt":
            adopt_durs.append(e.args["dur"])

    # ---- per-lane busy time ------------------------------------------
    for key in sorted(set(lane_busy) | set(stats.lane_busy_time)):
        a = stats.lane_busy_time.get(key, 0.0)
        b = lane_busy.get(key, 0.0)
        rep.add(f"lane_busy[{key}]", a, b, _close(a, b, rtol, atol))
    dev_busy = sum(lane_busy.get(k, 0.0) for k in ("prefill", "batch0", "serial"))
    rep.add("device_busy_time", stats.device_busy_time, dev_busy,
            _close(stats.device_busy_time, dev_busy, rtol, atol))

    # ---- realized / ideal overlap (the engine's N-lane formula) ------
    overlap = 0.0
    ideal = 0.0
    for it in sorted(set(dev_by_iter) | set(lanes_by_iter)):
        dev = dev_by_iter.get(it, [])
        lanes = lanes_by_iter.get(it, [])
        interval: List[List[Tuple[float, float]]] = []
        if dev:
            interval.append(list(dev))
        interval += [[(e.t0, e.t1)] for e in lanes]
        busy = [sum(t1 - t0 for t0, t1 in lw) for lw in interval]
        if len(interval) >= 2:
            union = _union([w for lw in interval for w in lw])
            total = sum(busy)
            overlap += max(0.0, total - union)
            ideal += max(0.0, total - max(busy))
        elif not dev and len(lanes) == 1 and (lanes[0].args or {}).get("inline"):
            # serialized batch-1-only step: the hideable half counts as
            # ideal-but-unrealized overlap (engine's inline branch)
            lane_t = busy[0]
            hb = lanes[0].args["host_busy"]
            ideal += max(0.0, min(hb, lane_t - hb))
    # plan-ahead adoptions grow BOTH (hidden planner time is realized
    # overlap); falsified speculations' fresh-plan time was hideable
    overlap += sum(adopt_durs)
    ideal += sum(adopt_durs) + hideable_plan

    rep.add("pipeline_overlap_time", stats.pipeline_overlap_time, overlap,
            _close(stats.pipeline_overlap_time, overlap, rtol, atol))
    rep.add("pipeline_ideal_time", stats.pipeline_ideal_time, ideal,
            _close(stats.pipeline_ideal_time, ideal, rtol, atol))
    if ideal <= 0:
        bubble = 0.0
    else:
        bubble = min(1.0, max(0.0, 1.0 - overlap / ideal))
    rep.add("bubble_fraction", stats.bubble_fraction, bubble,
            _close(stats.bubble_fraction, bubble, rtol, atol))

    # ---- plan-ahead hidden time + critical-path plan time ------------
    hidden = sum(adopt_durs)
    rep.add("planahead_hidden_time", stats.planahead_hidden_time, hidden,
            _close(stats.planahead_hidden_time, hidden, rtol, atol))
    rep.add("plan_busy_time", stats.plan_busy_time, plan_busy,
            _close(stats.plan_busy_time, plan_busy, rtol, atol))

    # ---- swap bytes hidden under the dispatch window (exact) ---------
    hidden_bytes = 0
    for e in copies:
        it = (e.args or {}).get("iter")
        win = dispatch_by_iter.get(it)
        if win is None:
            continue  # no dispatch window that step -> engine counted 0
        hidden_bytes += int(
            e.args["nbytes"] * _hidden_fraction(e.t0, e.t1, win[0], win[1]))
    rep.add("swap_hidden_bytes", stats.swap_hidden_bytes, hidden_bytes,
            stats.swap_hidden_bytes == hidden_bytes)
    return rep
