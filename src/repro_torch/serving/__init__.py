"""Multi-tenant adapter serving (port of ``repro/serving``): the LRU-paged
adapter bank, the continuous-batching engine and the SLO scheduler over it
(classes, EDF within a class, backpressure with reject / drop_lowest /
degrade shedding, deadline timeouts, retry with backoff)."""

from repro_torch.serving.adapter_store import (AdapterQuarantinedError,
                                               AdapterStore)
from repro_torch.serving.engine import Request, SamplingConfig, ServingEngine
from repro_torch.serving.scheduler import (ManualClock, RetryPolicy,
                                           SchedulerConfig, SLOScheduler)

__all__ = ["AdapterQuarantinedError", "AdapterStore", "ManualClock",
           "Request", "RetryPolicy", "SamplingConfig", "SchedulerConfig",
           "ServingEngine", "SLOScheduler"]
