"""PyTorch/CUDA port of the FediLoRA system (``src/repro`` is the JAX
reference it is held against).

The port grows slice by slice.  This package holds:

* the federated FediLoRA round — synthetic multimodal corpora with missing
  modalities, the training forward and loss, AdamW over rank-masked
  adapters, layer-wise editing and the aggregation registry, in one
  ``FederatedTrainer`` over resident or paged client state (every round
  timeline, FLoRA, checkpoints through ``repro_torch.checkpoint``, the
  CLI ``python -m repro_torch.launch.train``), with dimension-wise
  aggregation as hand-written CUDA kernels for Hopper
  (``kernels/csrc/dim_agg.cu``);
* the model stacks of every family (dense, prefix and cross-attention
  VLMs, MoE, MLA, Mamba-2, hybrid, encoder-decoder) for training, the
  evaluation's greedy decode and single-adapter decode;
* the multi-tenant adapter-serving path: chunked prefill, the LRU-paged
  adapter bank and the continuous-batching engine (every family but the
  cross-attention VLM and enc-dec, as in the reference), with the per-row
  multi-adapter LoRA projection (BGMV) as a hand-written CUDA kernel
  (``kernels/csrc/grouped_lora_matmul.cu``).

Entry points (``FederatedTrainer``, ``ServingEngine``, ``AdapterStore``,
``init_params``) run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of falling
back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device that is not there raises —
    the port never silently falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port "
            "on the CPU explicitly")
    return dev


__all__ = ["resolve_device"]
