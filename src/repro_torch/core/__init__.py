"""NEO core of the port: paged dual-pool KV cache, host attention, the
analytic + EWMA-calibrated perf model, the load-aware scheduler, the paged
executor and the serving engine."""

from repro_torch.core.engine import NeoEngine  # noqa: F401
from repro_torch.core.request import Request, RequestState  # noqa: F401
from repro_torch.core.scheduler import BatchPlan, NeoScheduler  # noqa: F401
