"""Multi-tenant adapter serving (port of ``repro/serving``): the LRU-paged
adapter bank and the continuous-batching engine.  The SLO scheduler is not
ported yet."""

from repro_torch.serving.adapter_store import (AdapterQuarantinedError,
                                               AdapterStore)
from repro_torch.serving.engine import Request, SamplingConfig, ServingEngine

__all__ = ["AdapterQuarantinedError", "AdapterStore", "Request",
           "SamplingConfig", "ServingEngine"]
