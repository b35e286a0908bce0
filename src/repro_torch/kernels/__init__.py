"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
wrappers, their plain PyTorch versions (``ref``) and their build
(``build``), with the public entry points in ``ops``.  Importing this
package builds nothing.

* ``grouped_lora_matmul`` — multi-tenant BGMV, replacing the Pallas kernel
  ``grouped_lora_matmul_pallas`` (``repro/kernels/lora_gather_matmul.py``);
* ``dim_agg`` — FediLoRA's dimension-wise aggregation and its trimmed
  mean, replacing ``dim_agg_pallas`` and ``dim_agg_trimmed_pallas``
  (``repro/kernels/dim_agg.py``);
* ``lora_matmul`` — the fused LoRA projection ``y = x@W + s·(x@Aᵀ)@Bᵀ``,
  replacing ``lora_matmul_pallas`` (``repro/kernels/lora_matmul.py``);
* ``flash`` — online-softmax attention with causal and sliding-window
  masks, replacing ``flash_attention_pallas``
  (``repro/kernels/flash_attention.py``);
* ``moe`` — the mixture-of-experts feed-forward of inference on one card
  (routing, grouped expert GEMMs over the routed picks, the combine),
  replacing no TPU kernel (the reference's MoE is ``jnp``).

Like the reference's package, this one exports ``flash_attention``,
``fused_lora_matmul``, ``dimension_wise_aggregate`` and
``fedilora_aggregate_tree`` from ``ops``; the wrapper modules keep names
that these functions do not shadow.
"""

from repro_torch.kernels.ops import (  # noqa: F401
    dimension_wise_aggregate,
    fedilora_aggregate_tree,
    flash_attention,
    fused_lora_matmul,
)
