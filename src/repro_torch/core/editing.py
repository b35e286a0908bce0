"""Layer-wise LoRA editing (FediLoRA Sec. 3.2; port of
``repro/core/editing.py``).

After local training and before aggregation, each client takes the cosine
similarity of every local LoRA-A module with the previous round's global
one (Eq. 6), selects the k least similar modules (Eq. 7, Min-K) and
soft-blends only those toward the global (Eq. 8):

    A^{y*} <- gamma_{y*} A^{y*} + (1 - gamma_{y*}) A_g^{y*}

``gamma`` is the similarity itself (the paper), 0 (full editing) or 0.5
(half editing).  Everything stays on the device; the selection breaks ties
toward the lower module index, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.tree import Tree

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class EditConfig:
    enabled: bool = True
    k: int = 1                          # Min-K: edit the k least-similar modules
    matrices: Literal["A", "B", "both", "none"] = "A"
    gamma_mode: Literal["similarity", "full", "half"] = "similarity"


def module_cosine_similarities(local: Tree, global_prev: Tree,
                               matrix: str = "A") -> torch.Tensor:
    """Per-module cosine similarity (Eq. 6), modules enumerated as (spec
    name in sorted order) × (layer index) → f32 [Y]."""
    sims = []
    for name in sorted(local):
        a_l = local[name][matrix].float()
        a_g = global_prev[name][matrix].float()
        axes = tuple(range(1, a_l.dim()))
        dot = (a_l * a_g).sum(dim=axes)
        nl = torch.sqrt(a_l.square().sum(dim=axes))
        ng = torch.sqrt(a_g.square().sum(dim=axes))
        sims.append(dot / torch.clamp(nl * ng, min=_EPS))
    return torch.cat(sims)


def _selection_mask(sims: torch.Tensor, k: int) -> torch.Tensor:
    """f32 [Y], 1 at the k smallest similarities (Min-K).  A stable sort
    puts equal similarities in index order, so ties select the lower
    module index — ``top_k(-sims)``'s choice."""
    k = min(k, sims.shape[0])
    idx = torch.sort(sims, stable=True).indices[:k]
    return torch.zeros_like(sims).index_fill_(0, idx, 1.0)


def edit_lora(local: Tree, global_prev: Tree, cfg: EditConfig
              ) -> tuple[Tree, dict]:
    """Apply layer-wise editing; returns (edited adapter, diagnostics with
    the similarity vector ``sims`` and the selection mask ``selected``)."""
    sims = module_cosine_similarities(local, global_prev, "A")
    if not cfg.enabled or cfg.matrices == "none":
        return local, {"sims": sims, "selected": torch.zeros_like(sims)}
    sel = _selection_mask(sims, cfg.k)
    if cfg.gamma_mode == "full":
        gammas = torch.zeros_like(sims)
    elif cfg.gamma_mode == "half":
        gammas = torch.full_like(sims, 0.5)
    else:                               # the paper: gamma = similarity (Eq. 8)
        gammas = sims
    edited = {}
    offset = 0
    for name in sorted(local):
        entry = dict(local[name])
        L = entry["A"].shape[0]
        s, g = sel[offset:offset + L], gammas[offset:offset + L]
        offset += L
        for mat in ("A", "B"):
            if cfg.matrices in (mat, "both"):
                loc, glo = entry[mat], global_prev[name][mat]
                bshape = (L,) + (1,) * (loc.dim() - 1)
                sb = s.reshape(bshape).to(loc.dtype)
                gb = g.reshape(bshape).to(loc.dtype)
                blended = gb * loc + (1.0 - gb) * glo.to(loc.dtype)
                entry[mat] = sb * blended + (1.0 - sb) * loc
        edited[name] = entry
    return edited, {"sims": sims, "selected": sel}


def edited_layer_index(diag: dict) -> torch.Tensor:
    """Index (module enumeration order) of the first edited module."""
    return torch.argmax(diag["selected"])


__all__ = ["EditConfig", "edit_lora", "edited_layer_index",
           "module_cosine_similarities"]
