"""Structured engine tracing (observability layer), the port's copy of the
JAX package's ``obs`` package.

:class:`~repro_torch.obs.tracer.SpanTracer` — a low-overhead, thread-safe,
monotonic-clock ring-buffer span tracer the engine instruments its
plan → launch → join loop with (``EngineConfig.tracing``; off by default
and bitwise-identical outputs either way).  Exports Chrome trace-event
JSON (Perfetto-loadable) plus a JSONL counter time-series.

:func:`~repro_torch.obs.reconcile.reconcile` — recomputes the overlap
accounting (lane busy time, realized/ideal overlap, bubble fraction,
swap-hidden bytes, plan-ahead hidden time) FROM the spans and asserts
agreement with :class:`~repro_torch.core.engine.EngineStats`, turning the
trace into a standing audit of the numbers every perf gate depends on.
"""

from repro_torch.obs.reconcile import ReconcileReport, reconcile
from repro_torch.obs.tracer import SpanEvent, SpanTracer

__all__ = ["SpanTracer", "SpanEvent", "ReconcileReport", "reconcile"]
