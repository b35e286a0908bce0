"""Federated fine-tuning (port of ``repro/federated``: the configuration
and the resident-state trainer)."""

from repro_torch.federated.config import FaultConfig, FederatedConfig  # noqa: F401
from repro_torch.federated.runtime import (ClientState,  # noqa: F401
                                           FederatedTrainer, ServerState)
