"""Plain PyTorch versions of the port's kernels: what the CPU runs, and what
each CUDA kernel is held against on the card."""

from __future__ import annotations

import math

import torch

#: the score a masked (query, key) pair gets, as in the JAX package's oracle
NEG_INF = -1e30


def lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """The fused LoRA projection ``y = x@W + scale·(x@Aᵀ)@Bᵀ``, accumulated
    in f32 and cast to x's dtype once.  x: [M, K]; w: [K, N]; a: [r, K];
    b: [N, r]."""
    x32 = x.float()
    base = x32 @ w.float()
    xa = x32 @ a.float().T
    delta = xa @ b.float().T
    return (base + scale * delta).to(x.dtype)


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain softmax attention over heads folded into the batch: q
    [BH, Sq, d]; k [BH, Sk, d]; v [BH, Sk, dv] → [BH, Sq, dv] in q's dtype.
    Scores in f32 scaled by 1/sqrt(d); query and key positions both start at
    0; a masked pair scores ``NEG_INF`` (so a row with no valid key averages
    every value, as the reference's oracle does)."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    Sq, Sk = q.shape[1], k.shape[1]
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window and window > 0:
        ok &= (qp - kp) < window
    s = torch.where(ok[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


__all__ = ["NEG_INF", "dim_agg_ref", "dim_agg_trimmed_ref",
           "flash_attention_ref", "grouped_lora_matmul_ref",
           "lora_matmul_ref"]
