"""Heterogeneous-rank LoRA state (port of ``repro/core/lora.py``).

Every adapter is materialised at the padded global rank ``r_g`` with rows
of ``A`` / columns of ``B`` beyond the tenant's rank set to zero, which
leaves ``B A`` unchanged — so one batched compute path serves every rank
mix.  LoRA parameters are ``{spec.name: {"A": [L, r_g, in], "B": [L, out,
r_g]}}``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from repro_torch.core.tree import Tree, tree_leaves
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
    """mask^(d) = 1[d < r_k] for d in 0..r_g-1 (paper Eq. 3).  ``r_k`` may
    be an int or a 0-d tensor (then the mask lives on its device)."""
    if isinstance(r_k, torch.Tensor):
        device = r_k.device
    return (torch.arange(r_g, device=device) < r_k).to(dtype)


def init_lora_params(specs: Sequence[LoRASpec], cfg: LoRAConfig, *,
                     generator: torch.Generator, client_rank=None,
                     device=None) -> Tree:
    """Standard LoRA init: A ~ N(0, 1/r), B = 0, so dW starts at zero.
    Shapes and masking are the reference's; the draws come from the torch
    ``generator`` (one ``randn`` per spec, in spec order).  With
    ``client_rank`` the rows of A beyond it are zeroed, so the padded state
    equals the ragged one."""
    dtype = getattr(torch, cfg.dtype)
    device = device if device is not None else generator.device
    params = {}
    for spec in specs:
        a = torch.randn((spec.num_layers, cfg.rank, spec.in_dim),
                        generator=generator, device=device, dtype=dtype)
        a = a / torch.sqrt(torch.tensor(float(max(cfg.rank, 1)),
                                        dtype=dtype, device=device))
        b = torch.zeros((spec.num_layers, spec.out_dim, cfg.rank),
                        device=device, dtype=dtype)
        if client_rank is not None:
            a = a * rank_mask(client_rank, cfg.rank, dtype,
                              device)[None, :, None]
        params[spec.name] = {"A": a, "B": b}
    return params


def mask_lora_params(params: Tree, r_k, r_g: int) -> Tree:
    """Zero rows of A / columns of B beyond the client rank (projection onto
    the ragged subspace).  Idempotent; ``r_k`` may be a 0-d tensor."""

    def _mask(entry):
        m = rank_mask(r_k, r_g, entry["A"].dtype, entry["A"].device)
        return {"A": entry["A"] * m[None, :, None],
                "B": entry["B"] * m[None, None, :]}

    return {name: _mask(entry) for name, entry in params.items()}


def truncate_redistribute(global_params: Tree, r_k, r_g: int) -> Tree:
    """Server -> client redistribution (HetLoRA, FediLoRA): the global
    rank-``r_g`` pair truncated to the client's rank."""
    return mask_lora_params(global_params, r_k, r_g)


def lora_delta(entry: Mapping[str, torch.Tensor], scale: float
               ) -> torch.Tensor:
    """dW = scale * B A for one spec, per stacked layer: [L, out, in]."""
    return scale * torch.einsum("lor,lri->loi", entry["B"], entry["A"])


def num_lora_params(specs: Sequence[LoRASpec], rank: int) -> int:
    return sum(s.num_layers * rank * (s.in_dim + s.out_dim) for s in specs)


def flatten_modules(params: Tree) -> list[tuple[str, int, Mapping]]:
    """Editable LoRA modules as (spec name, layer index, {"A", "B"}), specs
    in sorted order, layers in order — editing's enumeration."""
    return [(name, l, params[name]) for name in sorted(params)
            for l in range(params[name]["A"].shape[0])]


def tree_l2_norm(params: Tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(params)))


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


__all__ = ["LoRAConfig", "LoRASpec", "flatten_modules", "grouped_lora_matmul",
           "init_lora_params", "lora_delta", "lora_matmul", "mask_lora_params",
           "num_lora_params", "rank_mask", "tree_l2_norm",
           "truncate_redistribute"]
