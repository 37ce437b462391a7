"""Serving substrate: workload traces, latency/throughput metrics and the
discrete-event serving simulator."""

from repro_torch.serving.traces import (  # noqa: F401
    TraceRequest,
    azure_code_trace,
    osc_trace,
    poisson_arrivals,
    synthetic_trace,
)
from repro_torch.serving.metrics import RequestRecord, ServeMetrics  # noqa: F401
from repro_torch.serving.simulator import (  # noqa: F401
    FakePool,
    SimEngine,
    simulate,
    size_pools,
)
