"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
wrappers, their plain PyTorch versions (``ref``) and their build
(``build``).  Importing this package builds nothing.

* ``grouped_lora_matmul`` — multi-tenant BGMV, replacing the Pallas kernel
  ``grouped_lora_matmul_pallas`` (``repro/kernels/lora_gather_matmul.py``);
* ``dim_agg`` — FediLoRA's dimension-wise aggregation and its trimmed
  mean, replacing ``dim_agg_pallas`` and ``dim_agg_trimmed_pallas``
  (``repro/kernels/dim_agg.py``).
"""
