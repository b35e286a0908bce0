"""Heterogeneous-rank LoRA state (port of ``repro/core/lora.py``, the parts
serving needs).

Every adapter is materialised at the padded global rank ``r_g`` with rows
of ``A`` / columns of ``B`` beyond the tenant's rank set to zero, which
leaves ``B A`` unchanged — so one batched compute path serves every rank
mix.  LoRA parameters are ``{spec.name: {"A": [L, r_g, in], "B": [L, out,
r_g]}}``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.kernels.grouped_lora_matmul import \
    grouped_lora_matmul as _kernel_glm


@dataclasses.dataclass(frozen=True)
class LoRASpec:
    """One adapted weight family (a stack of ``num_layers`` matrices)."""

    name: str        # e.g. "s0.attn.wq"
    in_dim: int
    out_dim: int
    num_layers: int


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int                 # r_g, the padded/global rank
    alpha: float = 16.0       # LoRA scaling numerator
    targets: tuple = ("attn/wq", "attn/wv")
    dtype: str = "float32"

    @property
    def scale(self) -> float:
        return self.alpha / float(self.rank)


def rank_mask(r_k, r_g: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """mask^(d) = 1[d < r_k] for d in 0..r_g-1 (paper Eq. 3)."""
    return (torch.arange(r_g, device=device) < r_k).to(dtype)


def _promote(*ts: torch.Tensor) -> list[torch.Tensor]:
    """Cast to the common type, as jnp's einsum promotes mixed operands."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def lora_matmul(x: torch.Tensor, w: torch.Tensor,
                lora: Mapping[str, torch.Tensor] | None,
                scale: float) -> torch.Tensor:
    """``y = x @ w + scale * (x @ Aᵀ) @ Bᵀ``; x [..., in], w [in, out],
    A [r, in], B [out, r]."""
    y = x @ w
    if lora is not None:
        xc, a, b = _promote(x, lora["A"], lora["B"])
        delta = scale * torch.einsum(
            "...r,or->...o", torch.einsum("...i,ri->...r", xc, a), b)
        y = y + delta.to(y.dtype)
    return y


def grouped_lora_matmul(x: torch.Tensor, w: torch.Tensor,
                        bank: Mapping[str, torch.Tensor] | None,
                        idx: torch.Tensor, scale: float, *,
                        kernel: bool = False) -> torch.Tensor:
    """Per-row adapter-index LoRA projection (BGMV): leading-batch row ``b``
    of ``x`` applies adapter ``idx[b]`` of a stacked bank.

    ``x`` [B, ..., in]; ``w`` [in, out]; ``bank`` {"A": [G, r, in],
    "B": [G, out, r]} (``None`` → plain ``x @ w``); ``idx`` int [B],
    broadcast over the inner dims.  ``kernel=False`` gathers the per-row
    (A, B) pairs and contracts them row-wise.  ``kernel=True`` goes through
    ``repro_torch.kernels.grouped_lora_matmul``: the Hopper kernel on a CUDA
    tensor (or an error), the plain version on a CPU tensor.
    """
    if bank is None:
        return x @ w
    if kernel:
        return _kernel_glm(x, w, bank["A"], bank["B"], idx, scale=scale)
    a = bank["A"][idx]                                   # [B, r, in]
    b = bank["B"][idx]                                   # [B, out, r]
    y = x @ w
    xc, a, b = _promote(x, a, b)
    xa = torch.einsum("b...i,bri->b...r", xc, a)
    delta = scale * torch.einsum("b...r,bor->b...o", xa, b)
    return y + delta.to(y.dtype)


__all__ = ["LoRAConfig", "LoRASpec", "grouped_lora_matmul", "lora_matmul",
           "rank_mask"]
