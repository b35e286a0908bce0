"""Federated fine-tuning configuration (copy of
``repro/federated/config.py``)."""

from __future__ import annotations

import dataclasses

from repro_torch.core.editing import EditConfig
from repro_torch.federated.faults import FaultConfig


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    num_clients: int = 10
    sample_rate: float = 0.4                 # clients per round (paper: 0.4)
    # heterogeneous ranks 4..32 (paper Sec. 4); len must equal num_clients
    ranks: tuple = (4, 8, 8, 12, 12, 16, 16, 24, 32, 32)
    local_steps: int = 10
    batch_size: int = 8
    aggregator: str = "fedilora"             # a key of AGGREGATORS
    edit: EditConfig = dataclasses.field(default_factory=EditConfig)
    lora_alpha: float = 16.0
    missing_ratio: float = 0.0
    seed: int = 0
    hetlora_beta: float = 1.0
    hetlora_prune_gamma: float = 0.0         # >0 enables rank self-pruning
    # buffered asynchronous FL (the reference's run_round_async)
    buffer_size: int = 0
    staleness_decay: float = 0.5
    async_delays: tuple = ()
    measure_delays: bool = False
    delay_ema_beta: float = 0.5
    # host-backed client-state store (the reference's paged cohorts)
    paged: bool = False
    store_slots: int = 0
    store_host_slots: int | None = None
    store_spill_dir: str | None = None
    # client sampling: "uniform" or "availability" (down-weights clients
    # by their measured local-step EMA)
    sampling: str = "uniform"
    availability_alpha: float = 1.0
    # robustness: fault injection and the robust aggregators' knobs
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    clip_norm: float = 0.0
    trim_frac: float = 0.0

    @property
    def global_rank(self) -> int:
        return max(self.ranks)

    def homogeneous(self, rank: int = 12) -> "FederatedConfig":
        """Paper Table 3: every client at one rank (12)."""
        return dataclasses.replace(self, ranks=(rank,) * self.num_clients)


__all__ = ["FaultConfig", "FederatedConfig"]
