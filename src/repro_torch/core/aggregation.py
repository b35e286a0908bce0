"""Federated LoRA aggregation strategies (port of
``repro/core/aggregation.py``).

Every strategy takes *stacked* client adapters — each leaf carries a
leading client axis K (``A: [K, L, r_g, n]``, ``B: [K, L, m, r_g]``) — a
rank vector ``ranks`` int [K] and base weights ``p`` f32 [K] (normalised
local data sizes, paper Eq. 1), all tensors on one device.  Nothing here
reads a value back to the host: the zero-survivor ``fallback`` is a
``torch.where``, not a branch.

* ``fedavg``   — plain weighted mean.
* ``hetlora``  — zero-pad + sparsity (Frobenius-norm) weighted mean
                 (Cho et al. 2024), with rank self-pruning.
* ``flora``    — the dense stacked product sum_k p_k B_k A_k
                 (Wang et al. 2024).
* ``fedilora`` — the paper's dimension-wise reweighting (Eqs. 3-5).
* ``fedbuff``  — FediLoRA weights × the staleness discount (1+s)^-decay,
                 the forfeited mass anchored on the current global.
* ``fedilora_clip`` / ``fedilora_trimmed`` — update-norm clipping and the
                 dimension-wise trimmed mean (Koo et al. 2410.22815).

The ``*_kernel`` entries run the same algebra through the Hopper kernels of
``repro_torch/kernels/dim_agg.py``.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from repro_torch.core.tree import Tree, tree_leaves, tree_map
from repro_torch.kernels import dim_agg as DK
from repro_torch.telemetry import span

_EPS = 1e-12


def _client_masks(ranks: torch.Tensor, r_g: int,
                  dtype=torch.float32) -> torch.Tensor:
    """[K, r_g] binary masks, mask[k, d] = 1[d < r_k] (paper Eq. 3)."""
    d = torch.arange(r_g, device=ranks.device)
    return (d[None, :] < ranks[:, None]).to(dtype)


def dimension_wise_weights(ranks: torch.Tensor, p: torch.Tensor,
                           r_g: int) -> torch.Tensor:
    """Paper Eq. 4: p~_k^(d) = mask_k^(d) p_k / sum_j mask_j^(d) p_j →
    [K, r_g]; dimensions no client covers get all-zero weights."""
    num = _client_masks(ranks, r_g, p.dtype) * p[:, None]
    den = num.sum(0, keepdim=True)
    return num / torch.clamp(den, min=_EPS)


def client_update_norms(stacked: Tree) -> torch.Tensor:
    """Per-client Frobenius norm of the stacked update over every leaf,
    in f32 → [K]."""
    sq = sum(x.float().square().sum(dim=tuple(range(1, x.dim())))
             for x in tree_leaves(stacked))
    return torch.sqrt(sq)


def _apply_fallback(out: Tree, p: torch.Tensor,
                    fallback: Tree | None) -> Tree:
    """Zero-survivor guard: when the cohort's total weight is zero return
    ``fallback`` (the previous global) instead of the all-zero adapter; a
    bitwise no-op whenever any weight survives."""
    if fallback is None:
        return out
    alive = p.sum() > 0
    return tree_map(lambda o, f: torch.where(alive, o, f.to(o.dtype)),
                    out, fallback)


def _clip_active(clip) -> bool:
    """Clipping takes part only for a finite positive threshold."""
    return clip is not None and 0 < float(clip) < float("inf")


def _trim_active(trim) -> bool:
    return trim is not None and float(trim) > 0


def _global_rank(stacked: Tree) -> int:
    if not stacked:
        raise ValueError("empty LoRA tree")
    return next(iter(stacked.values()))["A"].shape[2]


# ---------------------------------------------------------------------------
# FedAvg, HetLoRA, FLoRA
# ---------------------------------------------------------------------------

def fedavg(stacked: Tree, ranks, p, fallback: Tree | None = None) -> Tree:
    """Data-size-weighted mean over the client axis (paper Eq. 1)."""
    pn = p / torch.clamp(p.sum(), min=_EPS)
    out = tree_map(lambda x: torch.einsum("k,k...->...", pn.to(x.dtype), x),
                   stacked)
    return _apply_fallback(out, p, fallback)


def hetlora_sparsity_weights(stacked: Tree, p, beta: float = 1.0
                             ) -> torch.Tensor:
    """HetLoRA reweights clients by the Frobenius norm of their update."""
    w = p * client_update_norms(stacked) ** beta
    return w / torch.clamp(w.sum(), min=_EPS)


def hetlora(stacked: Tree, ranks, p, beta: float = 1.0,
            fallback: Tree | None = None) -> Tree:
    """Zero-padding aggregation with sparsity weighting; the denominator is
    the total weight, so dimensions few clients cover are diluted."""
    w = hetlora_sparsity_weights(stacked, p, beta)
    out = tree_map(lambda x: torch.einsum("k,k...->...", w.to(x.dtype), x),
                   stacked)
    return _apply_fallback(out, p, fallback)


def hetlora_self_prune(entry: Mapping[str, torch.Tensor], rank, r_g: int,
                       gamma: float = 0.99) -> torch.Tensor:
    """HetLoRA rank self-pruning: drop trailing dimensions whose cumulative
    |A row|·|B col| mass is in the (1-gamma) tail.  Returns the pruned rank
    as a 0-d int tensor (never larger than ``rank``)."""
    a_mass = torch.sqrt(entry["A"].square().sum(dim=(0, 2)))      # [r_g]
    b_mass = torch.sqrt(entry["B"].square().sum(dim=(0, 1)))      # [r_g]
    mass = a_mass * b_mass
    cum = torch.cumsum(mass, 0) / torch.clamp(mass.sum(), min=_EPS)
    kept = (cum < gamma).sum() + 1
    rank = torch.as_tensor(rank, device=kept.device)
    return torch.clamp(torch.minimum(kept, rank), max=r_g)


def flora_delta(stacked: Tree, ranks, p, scale: float) -> dict:
    """Noise-free global update dW = sum_k p_k · scale · B_k A_k, as dense
    deltas {name: [L, m, n]}."""
    pn = p / torch.clamp(p.sum(), min=_EPS)
    return {name: scale * torch.einsum("k,klor,klri->loi",
                                       pn.to(e["A"].dtype), e["B"], e["A"])
            for name, e in stacked.items()}


# ---------------------------------------------------------------------------
# FediLoRA, FedBuff
# ---------------------------------------------------------------------------

def fedilora(stacked: Tree, ranks, p, fallback: Tree | None = None) -> Tree:
    """Paper Eqs. 3-5: row d of the global A (column d of B) averages only
    the clients with r_k > d, weights renormalised within that set."""
    pt = dimension_wise_weights(ranks, p, _global_rank(stacked))
    out = {}
    for name, e in stacked.items():
        w = pt.to(e["A"].dtype)
        out[name] = {"A": torch.einsum("kd,kldn->ldn", w, e["A"]),
                     "B": torch.einsum("kd,klmd->lmd", w, e["B"])}
    return _apply_fallback(out, p, fallback)


def fedilora_kernel(stacked: Tree, ranks, p,
                    fallback: Tree | None = None) -> Tree:
    """:func:`fedilora` through the ``dim_agg`` kernel."""
    return _apply_fallback(DK.fedilora_aggregate_tree(stacked, ranks, p), p,
                           fallback)


def staleness_discount(staleness: torch.Tensor, decay: float
                       ) -> torch.Tensor:
    """FedBuff's polynomial staleness discount (1 + s)^-decay → [K]."""
    return (1.0 + staleness) ** (-decay)


def _discounted_dimension_merge(stacked: Tree, ranks, p, disc,
                                anchor: Tree | None = None) -> Tree:
    """Shared core of ``fedbuff`` and ``fedilora_clip``: Eq. 4 weights ×
    a per-client discount ``disc`` [K], the forfeited per-dimension mass
    retained by ``anchor`` on covered dimensions."""
    pt = dimension_wise_weights(ranks, p, _global_rank(stacked))
    w = pt * disc[:, None]
    covered = (pt.sum(0) > 0).to(pt.dtype)
    resid = covered * (1.0 - w.sum(0))
    out = {}
    for name, e in stacked.items():
        wk = w.to(e["A"].dtype)
        ga = torch.einsum("kd,kldn->ldn", wk, e["A"])
        gb = torch.einsum("kd,klmd->lmd", wk, e["B"])
        if anchor is not None:
            r = resid.to(e["A"].dtype)
            ga = ga + r[None, :, None] * anchor[name]["A"]
            gb = gb + r[None, None, :] * anchor[name]["B"]
        out[name] = {"A": ga, "B": gb}
    return out


def fedbuff(stacked: Tree, ranks, p, staleness=None, anchor=None,
            decay: float = 0.5, fallback: Tree | None = None) -> Tree:
    """Buffered-async merge: ŵ_k^(d) = p~_k^(d) (1+s_k)^-decay, the mass
    the discount forfeits kept by ``anchor``; at staleness 0 it is
    :func:`fedilora`."""
    disc = (torch.ones_like(p) if staleness is None
            else staleness_discount(staleness.to(p.dtype), decay))
    return _apply_fallback(
        _discounted_dimension_merge(stacked, ranks, p, disc, anchor), p,
        fallback)


def fedbuff_kernel(stacked: Tree, ranks, p, staleness=None, anchor=None,
                   decay: float = 0.5, fallback: Tree | None = None) -> Tree:
    """:func:`fedbuff` through the ``dim_agg`` kernel (discount as its
    per-client scale)."""
    out = DK.fedbuff_aggregate_tree(stacked, ranks, p, staleness, anchor,
                                    decay=decay)
    return _apply_fallback(out, p, fallback)


# ---------------------------------------------------------------------------
# Byzantine-robust variants
# ---------------------------------------------------------------------------

def fedilora_clip(stacked: Tree, ranks, p, clip: float | None = None,
                  anchor: Tree | None = None,
                  fallback: Tree | None = None) -> Tree:
    """Dimension-wise aggregation with per-client update-norm clipping
    c_k = min(1, clip/||u_k||); ``clip`` of None/0/inf is :func:`fedilora`."""
    if not _clip_active(clip):
        return _apply_fallback(fedilora(stacked, ranks, p), p, fallback)
    norms = client_update_norms(stacked)
    disc = torch.clamp(clip / torch.clamp(norms, min=_EPS),
                       max=1.0).to(p.dtype)
    return _apply_fallback(
        _discounted_dimension_merge(stacked, ranks, p, disc, anchor), p,
        fallback)


def fedilora_clip_kernel(stacked: Tree, ranks, p, clip: float | None = None,
                         anchor: Tree | None = None,
                         fallback: Tree | None = None) -> Tree:
    """:func:`fedilora_clip` with the clip factors as the ``dim_agg``
    kernel's per-client scale."""
    if not _clip_active(clip):
        return _apply_fallback(fedilora_kernel(stacked, ranks, p), p,
                               fallback)
    return _apply_fallback(DK.fedilora_clip_tree(stacked, ranks, p, clip,
                                                 anchor), p, fallback)


def trimmed_dimension_counts(cover: torch.Tensor, trim: float
                             ) -> torch.Tensor:
    """t_d = min(⌊trim·m_d⌋, ⌊(m_d-1)/2⌋), clamped ≥ 0, over the m_d
    clients covering dimension d → f32 [r_g]."""
    m = cover.sum(0)
    t = torch.minimum(torch.floor(trim * m), torch.floor((m - 1.0) / 2.0))
    return torch.clamp(t, min=0.0)


def _trimmed_merge(x: torch.Tensor, p, cover, t) -> torch.Tensor:
    """Elementwise trimmed weighted mean over the client axis of x
    [K, L, r, n] (counting ranks by value, ties by client index)."""
    K = x.shape[0]
    xf = x.float()
    xi, xj = xf[:, None], xf[None, :]                  # [K,1,...], [1,K,...]
    ki = torch.arange(K, device=x.device).reshape(K, 1, 1, 1, 1)
    kj = ki.reshape(1, K, 1, 1, 1)
    cj = cover.float()[None, :, None, :, None]
    lo = (cj * ((xj < xi) | ((xj == xi) & (kj < ki)))).sum(1)
    hi = (cj * ((xj > xi) | ((xj == xi) & (kj > ki)))).sum(1)
    tb = t.float()[None, None, :, None]
    keep = cover.float()[:, None, :, None] * (lo >= tb) * (hi >= tb)
    pw = p.float()[:, None, None, None]
    num = (keep * pw * xf).sum(0)
    den = (keep * pw).sum(0)
    return (num / torch.clamp(den, min=_EPS)).to(x.dtype)


def fedilora_trimmed(stacked: Tree, ranks, p, trim: float = 0.0,
                     fallback: Tree | None = None) -> Tree:
    """Dimension-wise trimmed mean; ``trim == 0`` is :func:`fedilora`."""
    if not _trim_active(trim):
        return _apply_fallback(fedilora(stacked, ranks, p), p, fallback)
    cover = (_client_masks(ranks, _global_rank(stacked), p.dtype)
             * (p > 0).to(p.dtype)[:, None])
    t = trimmed_dimension_counts(cover, trim)
    out = {name: {
        "A": _trimmed_merge(e["A"], p, cover, t),
        "B": _trimmed_merge(e["B"].transpose(-1, -2), p, cover,
                            t).transpose(-1, -2)}
        for name, e in stacked.items()}
    return _apply_fallback(out, p, fallback)


def fedilora_trimmed_kernel(stacked: Tree, ranks, p, trim: float = 0.0,
                            fallback: Tree | None = None) -> Tree:
    """:func:`fedilora_trimmed` through the ``dim_agg_trimmed`` kernel."""
    if not _trim_active(trim):
        return _apply_fallback(fedilora_kernel(stacked, ranks, p), p,
                               fallback)
    return _apply_fallback(DK.fedilora_trimmed_tree(stacked, ranks, p, trim),
                           p, fallback)


# ---------------------------------------------------------------------------
# registry — the one dispatch point for every round
# ---------------------------------------------------------------------------
#
# Every entry has the signature
#     fn(stacked, ranks, p, *, hetlora_beta, lora_scale, staleness, anchor,
#        staleness_decay, clip, trim, fallback) -> (global_lora, base_delta)
# and exactly one output is not None: adapter-space strategies return a new
# global adapter, FLoRA returns dense weight deltas.

AGGREGATORS: dict[str, Callable] = {
    "fedavg": lambda s, r, p, *, fallback=None, **kw: (
        fedavg(s, r, p, fallback=fallback), None),
    "hetlora": lambda s, r, p, *, hetlora_beta=1.0, fallback=None, **kw: (
        hetlora(s, r, p, hetlora_beta, fallback=fallback), None),
    "fedilora": lambda s, r, p, *, fallback=None, **kw: (
        fedilora(s, r, p, fallback=fallback), None),
    "fedilora_kernel": lambda s, r, p, *, fallback=None, **kw: (
        fedilora_kernel(s, r, p, fallback=fallback), None),
    "flora": lambda s, r, p, *, lora_scale=1.0, **kw: (
        None, flora_delta(s, r, p, lora_scale)),
    "fedbuff": lambda s, r, p, *, staleness=None, anchor=None,
    staleness_decay=0.5, fallback=None, **kw: (
        fedbuff(s, r, p, staleness, anchor, staleness_decay,
                fallback=fallback), None),
    "fedbuff_kernel": lambda s, r, p, *, staleness=None, anchor=None,
    staleness_decay=0.5, fallback=None, **kw: (
        fedbuff_kernel(s, r, p, staleness, anchor, staleness_decay,
                       fallback=fallback), None),
    "fedilora_clip": lambda s, r, p, *, clip=None, anchor=None,
    fallback=None, **kw: (
        fedilora_clip(s, r, p, clip, anchor, fallback=fallback), None),
    "fedilora_clip_kernel": lambda s, r, p, *, clip=None, anchor=None,
    fallback=None, **kw: (
        fedilora_clip_kernel(s, r, p, clip, anchor, fallback=fallback), None),
    "fedilora_trimmed": lambda s, r, p, *, trim=0.0, fallback=None, **kw: (
        fedilora_trimmed(s, r, p, trim, fallback=fallback), None),
    "fedilora_trimmed_kernel": lambda s, r, p, *, trim=0.0, fallback=None,
    **kw: (fedilora_trimmed_kernel(s, r, p, trim, fallback=fallback), None),
}


def aggregate(name: str, stacked: Tree, ranks, p, *,
              hetlora_beta: float = 1.0, lora_scale: float = 1.0,
              staleness=None, anchor: Tree | None = None,
              staleness_decay: float = 0.5, clip: float | None = None,
              trim: float = 0.0, fallback: Tree | None = None):
    """One server aggregation through :data:`AGGREGATORS`; returns
    ``(global_lora, base_delta)``.  The global adapter comes back
    contiguous: its layout decides how the next round's products round,
    and a checkpoint restores contiguous tensors, so a resumed run is
    bit-identical only if the live one is contiguous too.  Runs in an
    ``aggregate`` span (``repro_torch.telemetry.span``)."""
    try:
        fn = AGGREGATORS[name]
    except KeyError:
        raise ValueError(f"unknown aggregator {name!r}; have "
                         f"{sorted(AGGREGATORS)}") from None
    with span("aggregate"):
        glob, delta = fn(stacked, ranks, p, hetlora_beta=hetlora_beta,
                         lora_scale=lora_scale, staleness=staleness,
                         anchor=anchor, staleness_decay=staleness_decay,
                         clip=clip, trim=trim, fallback=fallback)
        if glob is not None:
            glob = tree_map(lambda x: x.contiguous(), glob)
    return glob, delta


__all__ = ["AGGREGATORS", "aggregate", "client_update_norms",
           "dimension_wise_weights", "fedavg", "fedbuff", "fedbuff_kernel",
           "fedilora", "fedilora_clip", "fedilora_clip_kernel",
           "fedilora_kernel", "fedilora_trimmed", "fedilora_trimmed_kernel",
           "flora_delta", "hetlora", "hetlora_self_prune",
           "hetlora_sparsity_weights", "staleness_discount",
           "trimmed_dimension_counts"]
