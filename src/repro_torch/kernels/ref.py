"""Plain PyTorch versions of the port's kernels: what the CPU runs, and what
each CUDA kernel is held against on the card."""

from __future__ import annotations

import torch


def grouped_lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, idx: torch.Tensor, *,
                            scale: float = 1.0) -> torch.Tensor:
    """Per-row adapter gather (BGMV), accumulated in f32:
    ``y[m] = x[m]@W + scale·(x[m]@A[idx[m]]ᵀ)@B[idx[m]]ᵀ``.

    x: [M, K]; w: [K, N]; a: [G, r, K]; b: [G, N, r]; idx: int [M].
    Returns [M, N] in the dtype of x."""
    idx = idx.long()
    x32 = x.float()
    base = x32 @ w.float()
    xa = torch.einsum("mk,mrk->mr", x32, a[idx].float())
    delta = torch.einsum("mr,mnr->mn", xa, b[idx].float())
    return (base + scale * delta).to(x.dtype)


__all__ = ["grouped_lora_matmul_ref"]
