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


def dim_agg_ref(stacked: torch.Tensor, weights: torch.Tensor,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """FediLoRA Eq. 5 in f32: ``out[l,d,:] = Σ_k w[k,d]·s_k·x[k,l,d,:]``.
    stacked: [K, L, r, n]; weights: [K, r]; scale: optional [K] (or
    [K, 1]) per-client factor.  Returns [L, r, n] in the dtype of
    stacked."""
    w = weights.float()
    if scale is not None:
        w = w * scale.float().reshape(-1, 1)
    acc = torch.einsum("kd,kldn->ldn", w, stacked.float())
    return acc.to(stacked.dtype)


def dim_agg_trimmed_ref(stacked: torch.Tensor, p: torch.Tensor,
                        cover: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-element trimmed weighted mean over the client axis.
    stacked: [K, L, r, n]; p: [K]; cover: [K, r]; t: [r].  Per element,
    client i's counting ranks among the covering clients — ``lo`` below
    it, ``hi`` above it, equal values ordered by client index — decide
    whether it survives (``lo >= t[d]`` and ``hi >= t[d]``); survivors are
    averaged with weights p renormalised; uncovered elements are 0.  The
    comparison loops over the K partners instead of materialising a
    [K, K, ...] block, with the reference's arithmetic."""
    K = stacked.shape[0]
    x = stacked.float()
    cov = cover.float()
    ki = torch.arange(K, device=x.device).reshape(K, 1, 1, 1)
    lo = torch.zeros_like(x)
    hi = torch.zeros_like(x)
    for j in range(K):
        xj = x[j:j + 1]
        cj = cov[j].reshape(1, 1, -1, 1)
        lo += cj * ((xj < x) | ((xj == x) & (j < ki)))
        hi += cj * ((xj > x) | ((xj == x) & (j > ki)))
    tb = t.float().reshape(1, 1, -1, 1)
    keep = cov[:, None, :, None] * (lo >= tb) * (hi >= tb)
    pw = p.float().reshape(K, 1, 1, 1)
    num = (keep * pw * x).sum(0)
    den = (keep * pw).sum(0)
    return (num / torch.clamp(den, min=1e-12)).to(stacked.dtype)


__all__ = ["dim_agg_ref", "dim_agg_trimmed_ref", "grouped_lora_matmul_ref"]
