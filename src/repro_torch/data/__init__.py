"""Synthetic multimodal federated corpora (numpy copies of ``repro/data``:
the same seeds give the same arrays, bit for bit)."""

from repro_torch.data.synthetic import (  # noqa: F401
    MultimodalBatch,
    SyntheticTaskConfig,
    make_federated_datasets,
    make_synthetic_dataset,
)
from repro_torch.data.partition import dirichlet_partition  # noqa: F401
from repro_torch.data.missing import apply_missing_modality  # noqa: F401
from repro_torch.data.partition import heterogeneous_sizes  # noqa: F401
from repro_torch.data.synthetic import BOS, EOS, PAD, SEP  # noqa: F401
