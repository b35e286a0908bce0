"""Dimension-wise aggregation of stacked client adapters (FediLoRA Eqs.
3-5, and the trimmed mean of ``fedilora_trimmed``).

Port of the Pallas kernels ``dim_agg_pallas`` and ``dim_agg_trimmed_pallas``
(``repro/kernels/dim_agg.py``) and of their wrappers in
``repro/kernels/ops.py``.  On a CUDA tensor each wrapper launches the
hand-written Hopper kernel (``csrc/dim_agg.cu``, built by ``build.py`` at
first use) or raises; on a CPU tensor it computes the plain version in
``ref.py``.  ``launches`` counts kernel launches per kernel.

A leaf is reduced in its own layout: ``rank_axis=2`` for an A leaf
``[K, L, r, n]``, ``rank_axis=3`` for a B leaf ``[K, L, m, r]``, so B needs
no transposed copy and its result comes back as ``[L, m, r]``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import dim_agg_ref, dim_agg_trimmed_ref

#: kernel launches since the last reset, per kernel (CPU calls never count)
launches = {"dim_agg": 0, "dim_agg_trimmed": 0}
#: the trimmed kernel holds an element's K client values in a local array
MAX_CLIENTS = 32
_FNS: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _kernel_fn(name: str):
    if name not in _FNS:
        from repro_torch.kernels.build import build
        fn = getattr(build("dim_agg"), f"{name}_launch")
        n_ptr = 4 if name == "dim_agg" else 5
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _check_leaf(stacked: torch.Tensor, rank_axis: int) -> int:
    """Validate a stacked leaf for the kernels; returns its rank r."""
    if rank_axis not in (2, 3):
        raise ValueError(f"rank_axis {rank_axis}: 2 (A layout) or 3 "
                         "(B layout)")
    if stacked.dim() != 4:
        raise ValueError(f"stacked leaf must be [K, L, P, Q], got "
                         f"{tuple(stacked.shape)}")
    if stacked.dtype != torch.float32:
        raise TypeError(f"stacked dtype {stacked.dtype}: the kernels take "
                        "f32 adapters")
    if not stacked.is_contiguous():
        raise ValueError("stacked leaf must be contiguous")
    if stacked.device.type != "cuda":
        raise ValueError(f"stacked leaf on {stacked.device}: the kernel "
                         "needs a CUDA tensor")
    return stacked.shape[rank_axis]


def _operand(t: torch.Tensor, shape: tuple, name: str,
             like: torch.Tensor) -> torch.Tensor:
    """A small f32 operand, checked for shape and device."""
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, stacked on {like.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    return t.float().contiguous()


def _dims(stacked: torch.Tensor) -> list[int]:
    K, L, P, Q = stacked.shape
    for v in (K, L, P, Q):
        if v >= 2 ** 31:
            raise ValueError(f"dimension {v} too large for the kernel")
    return [K, L, P, Q]


def dim_agg_cuda(stacked: torch.Tensor, weights: torch.Tensor,
                 scale: torch.Tensor | None = None, *,
                 rank_axis: int = 2) -> torch.Tensor:
    """Launch ``dim_agg`` on one stacked CUDA leaf: ``weights`` [K, r],
    optional ``scale`` [K] → the leaf's layout without K."""
    r = _check_leaf(stacked, rank_axis)
    K = stacked.shape[0]
    w = _operand(weights, (K, r), "weights", stacked)
    if scale is not None and tuple(scale.shape) == (K, 1):
        scale = scale[:, 0]                 # the Pallas operand's layout
    s = None if scale is None else _operand(scale, (K,), "scale", stacked)
    out = torch.empty(stacked.shape[1:], dtype=stacked.dtype,
                      device=stacked.device)
    err = _kernel_fn("dim_agg")(
        stacked.data_ptr(), w.data_ptr(), None if s is None else s.data_ptr(),
        out.data_ptr(), *_dims(stacked), rank_axis,
        torch.cuda.current_stream(stacked.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dim_agg kernel launch failed: cudaError {err}")
    launches["dim_agg"] += 1
    return out


def dim_agg_trimmed_cuda(stacked: torch.Tensor, p: torch.Tensor,
                         cover: torch.Tensor, t: torch.Tensor, *,
                         rank_axis: int = 2) -> torch.Tensor:
    """Launch ``dim_agg_trimmed`` on one stacked CUDA leaf: client weights
    ``p`` [K], coverage ``cover`` [K, r], trim counts ``t`` [r]."""
    r = _check_leaf(stacked, rank_axis)
    K = stacked.shape[0]
    if K > MAX_CLIENTS:
        raise ValueError(f"{K} clients: the trimmed kernel takes at most "
                         f"{MAX_CLIENTS}")
    pw = _operand(p, (K,), "p", stacked)
    cov = _operand(cover, (K, r), "cover", stacked)
    tt = _operand(t, (r,), "t", stacked)
    out = torch.empty(stacked.shape[1:], dtype=stacked.dtype,
                      device=stacked.device)
    err = _kernel_fn("dim_agg_trimmed")(
        stacked.data_ptr(), pw.data_ptr(), cov.data_ptr(), tt.data_ptr(),
        out.data_ptr(), *_dims(stacked), rank_axis,
        torch.cuda.current_stream(stacked.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dim_agg_trimmed kernel launch failed: "
                           f"cudaError {err}")
    launches["dim_agg_trimmed"] += 1
    return out


def _rank_rows(x: torch.Tensor, rank_axis: int) -> torch.Tensor:
    """A leaf of either layout as [K, L, r, n] (a view)."""
    if rank_axis not in (2, 3):
        raise ValueError(f"rank_axis {rank_axis}: 2 (A layout) or 3 "
                         "(B layout)")
    return x if rank_axis == 2 else x.transpose(-1, -2)


def plain_dim_agg(stacked, weights, scale=None, *, rank_axis: int = 2):
    """The plain version of ``dim_agg`` (``ref.dim_agg_ref``) on a leaf of
    either layout."""
    return _rank_rows(dim_agg_ref(_rank_rows(stacked, rank_axis), weights,
                                  scale), rank_axis)


def plain_dim_agg_trimmed(stacked, p, cover, t, *, rank_axis: int = 2):
    """The plain version of ``dim_agg_trimmed`` on a leaf of either
    layout."""
    return _rank_rows(dim_agg_trimmed_ref(_rank_rows(stacked, rank_axis), p,
                                          cover, t), rank_axis)


def dimension_wise_aggregate(stacked: torch.Tensor, weights: torch.Tensor,
                             scale: torch.Tensor | None = None, *,
                             rank_axis: int = 2) -> torch.Tensor:
    """FediLoRA Eq. 5 over one stacked leaf with w̃ [K, r]; ``scale`` [K]
    optionally multiplies each client's weight row (the FedBuff staleness
    discount or the clip factor)."""
    if stacked.device.type == "cuda":
        return dim_agg_cuda(stacked, weights, scale, rank_axis=rank_axis)
    if stacked.device.type == "cpu":
        return plain_dim_agg(stacked, weights, scale, rank_axis=rank_axis)
    raise ValueError(f"no dim_agg for device {stacked.device}")


def dimension_wise_trimmed(stacked: torch.Tensor, p: torch.Tensor,
                           cover: torch.Tensor, t: torch.Tensor, *,
                           rank_axis: int = 2) -> torch.Tensor:
    """Per-element trimmed weighted mean over one stacked leaf."""
    if stacked.device.type == "cuda":
        return dim_agg_trimmed_cuda(stacked, p, cover, t, rank_axis=rank_axis)
    if stacked.device.type == "cpu":
        return plain_dim_agg_trimmed(stacked, p, cover, t,
                                     rank_axis=rank_axis)
    raise ValueError(f"no dim_agg_trimmed for device {stacked.device}")


# ---------------------------------------------------------------------------
# tree functions (port of ``ops.py:97-209``): one launch per leaf
# ---------------------------------------------------------------------------

def _global_rank(stacked_tree) -> int:
    return next(iter(stacked_tree.values()))["A"].shape[2]


def fedilora_aggregate_tree(stacked_tree, ranks, p):
    """Kernel-backed FediLoRA aggregation over a stacked LoRA tree."""
    from repro_torch.core.aggregation import dimension_wise_weights

    w = dimension_wise_weights(ranks, p, _global_rank(stacked_tree))
    return {name: {"A": dimension_wise_aggregate(e["A"], w, rank_axis=2),
                   "B": dimension_wise_aggregate(e["B"], w, rank_axis=3)}
            for name, e in stacked_tree.items()}


def discounted_aggregate_tree(stacked_tree, ranks, p, disc, anchor=None):
    """Kernel-backed discounted dimension-wise merge — the shared core of
    the FedBuff staleness merge and ``fedilora_clip``: the per-client
    discount ``disc`` [K] rides the kernel's ``scale`` operand, and the
    per-dimension mass it forfeits stays on ``anchor``."""
    from repro_torch.core.aggregation import dimension_wise_weights

    w = dimension_wise_weights(ranks, p, _global_rank(stacked_tree))
    covered = (w.sum(0) > 0).to(w.dtype)                       # [r_g]
    resid = covered * (1.0 - (w * disc[:, None]).sum(0))
    out = {}
    for name, e in stacked_tree.items():
        a = dimension_wise_aggregate(e["A"], w, disc, rank_axis=2)
        b = dimension_wise_aggregate(e["B"], w, disc, rank_axis=3)
        if anchor is not None:
            r = resid.to(a.dtype)
            a = a + r[None, :, None] * anchor[name]["A"]
            b = b + r[None, None, :] * anchor[name]["B"]
        out[name] = {"A": a, "B": b}
    return out


def fedbuff_aggregate_tree(stacked_tree, ranks, p, staleness=None,
                           anchor=None, *, decay: float = 0.5):
    """Kernel-backed FedBuff merge (staleness discount in the kernel)."""
    from repro_torch.core.aggregation import staleness_discount

    if staleness is None:
        disc = torch.ones_like(p)
    else:
        disc = staleness_discount(staleness.to(p.dtype), decay)
    return discounted_aggregate_tree(stacked_tree, ranks, p, disc, anchor)


def fedilora_clip_tree(stacked_tree, ranks, p, clip: float, anchor=None):
    """Kernel-backed ``fedilora_clip``: the clip factors
    ``min(1, clip/||u_k||)`` ride the kernel's ``scale`` operand."""
    from repro_torch.core.aggregation import client_update_norms

    norms = client_update_norms(stacked_tree)
    disc = torch.clamp(clip / torch.clamp(norms, min=1e-12),
                       max=1.0).to(p.dtype)
    return discounted_aggregate_tree(stacked_tree, ranks, p, disc, anchor)


def fedilora_trimmed_tree(stacked_tree, ranks, p, trim: float):
    """Kernel-backed ``fedilora_trimmed``: the trimmed mean of A (rank rows)
    and B (rank columns) runs in ``dim_agg_trimmed``."""
    from repro_torch.core.aggregation import (_client_masks,
                                              trimmed_dimension_counts)

    cover = (_client_masks(ranks, _global_rank(stacked_tree), p.dtype)
             * (p > 0).to(p.dtype)[:, None])                   # [K, r_g]
    t = trimmed_dimension_counts(cover, trim)
    return {name: {
        "A": dimension_wise_trimmed(e["A"], p, cover, t, rank_axis=2),
        "B": dimension_wise_trimmed(e["B"], p, cover, t, rank_axis=3)}
        for name, e in stacked_tree.items()}


__all__ = ["MAX_CLIENTS", "dim_agg_cuda", "dim_agg_trimmed_cuda",
           "dimension_wise_aggregate", "dimension_wise_trimmed",
           "discounted_aggregate_tree", "fedbuff_aggregate_tree",
           "fedilora_aggregate_tree", "fedilora_clip_tree",
           "fedilora_trimmed_tree", "launches", "plain_dim_agg",
           "plain_dim_agg_trimmed", "reset_launches"]
