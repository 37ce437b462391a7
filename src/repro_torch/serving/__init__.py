"""Serving substrate: workload traces and latency/throughput metrics."""

from repro_torch.serving.traces import (  # noqa: F401
    TraceRequest,
    azure_code_trace,
    osc_trace,
    poisson_arrivals,
    synthetic_trace,
)
from repro_torch.serving.metrics import RequestRecord, ServeMetrics  # noqa: F401
