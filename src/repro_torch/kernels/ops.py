"""The port's counterpart of ``repro.kernels.ops``: the public entry points
of its kernels, with the reference's names.

Each function launches its hand-written Hopper kernel on CUDA tensors and
computes the plain version (``ref``) on CPU tensors.  The reference's tile
arguments (``bm``, ``bn``, ``bk``, ``bq``, ``interpret``) have no
counterpart: each kernel picks its own tiles and masks ragged edges itself.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.dim_agg import (dimension_wise_aggregate,
                                         dimension_wise_trimmed,
                                         discounted_aggregate_tree,
                                         fedbuff_aggregate_tree,
                                         fedilora_aggregate_tree,
                                         fedilora_clip_tree,
                                         fedilora_trimmed_tree)
from repro_torch.kernels.flash import flash_attention
from repro_torch.kernels.grouped_lora_matmul import grouped_lora_matmul
from repro_torch.kernels.lora_matmul import fused_lora_matmul

__all__ = ["fused_lora_matmul", "grouped_lora_matmul",
           "dimension_wise_aggregate", "dimension_wise_trimmed",
           "fedilora_aggregate_tree", "discounted_aggregate_tree",
           "fedbuff_aggregate_tree", "fedilora_clip_tree",
           "fedilora_trimmed_tree", "flash_attention", "ref"]
