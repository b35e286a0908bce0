"""Federated fine-tuning (port of ``repro/federated``: the configuration,
the fault schedule, the paged client store and the trainer)."""

from repro_torch.federated.config import FederatedConfig  # noqa: F401
from repro_torch.federated.faults import FaultConfig, FaultSchedule  # noqa: F401
from repro_torch.federated.runtime import (ClientState,  # noqa: F401
                                           FederatedTrainer, ServerState)
