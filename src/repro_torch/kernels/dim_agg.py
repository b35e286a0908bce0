"""Dimension-wise aggregation of stacked client adapters (FediLoRA Eqs.
3-5, and the trimmed mean of ``fedilora_trimmed``).

Port of the Pallas kernels ``dim_agg_pallas`` and ``dim_agg_trimmed_pallas``
(``repro/kernels/dim_agg.py``) and of their wrappers in
``repro/kernels/ops.py``.  On CUDA tensors each wrapper launches the
hand-written Hopper kernel (``csrc/dim_agg.cu``, built by ``build.py`` at
first use) or raises; on CPU tensors it computes the plain version in
``ref.py``.

A leaf is reduced in its own layout: ``rank_axis=2`` for an A leaf
``[K, L, r, n]``, ``rank_axis=3`` for a B leaf ``[K, L, m, r]``, so B needs
no transposed copy and its result comes back as ``[L, m, r]``.

One launch reduces every leaf of a tree: the leaves share the client
weights, and the wrapper packs them into a table (``pack_leaves``: at most
``MAX_LEAVES`` leaves a launch, each owning a run of tiles of the grid), so
``fedilora_aggregate_tree`` and the other tree functions launch once per
tree on CUDA.  A one-leaf call is a one-entry table.  ``dim_agg`` reads a
leaf with 16-byte vectors or with scalar loads, as ``dim_agg_route`` picks
from the leaf's last dimension and whether its bases are 16-byte aligned;
``dim_agg_trimmed`` runs its instance compiled for the tree's client count
K.

``launches`` counts kernel launches per kernel, ``leaves_by_route`` the
leaves ``dim_agg`` reduced on each route and ``launches_by_clients`` the
trimmed kernel's launches per instance (K).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import aligned16
from repro_torch.kernels.ref import dim_agg_ref, dim_agg_trimmed_ref
from repro_torch.telemetry import span

#: kernel launches since the last reset, per kernel (CPU calls never count)
launches = {"dim_agg": 0, "dim_agg_trimmed": 0}
#: leaves reduced by ``dim_agg`` on each route since the last reset
leaves_by_route = {"vector": 0, "scalar": 0}
#: ``dim_agg_trimmed`` launches per compiled client count K since the last
#: reset
launches_by_clients: dict[int, int] = {}
#: the trimmed kernel is compiled for each client count up to this one and
#: holds an element's K client values in registers
MAX_CLIENTS = 32
#: the kernels stage the weights or coverage of a client as r floats of
#: shared memory
MAX_RANK = 256
#: leaves in one launch's table (the kernel's parameter)
MAX_LEAVES = 32
#: output elements of a ``dim_agg`` tile (a block: 256 threads x 4)
DIM_AGG_TILE = 1024
#: output elements of a ``dim_agg_trimmed`` tile (a block: 256 threads x 1)
TRIMMED_TILE = 256
_FNS: dict = {}


class _Leaf(ctypes.Structure):
    """``DimAggLeaf`` of ``csrc/dim_agg.cu``: one leaf of a launch."""
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n_out", ctypes.c_longlong), ("P", ctypes.c_int),
                ("Q", ctypes.c_int), ("rank_axis", ctypes.c_int),
                ("vec", ctypes.c_int), ("tile0", ctypes.c_int),
                ("tiles", ctypes.c_int)]


def reset_launches() -> None:
    for counts in (launches, leaves_by_route):
        for k in counts:
            counts[k] = 0
    launches_by_clients.clear()


def dim_agg_route(Q: int, aligned: bool) -> str:
    """The loads ``dim_agg`` reads a leaf with: ``"vector"`` (16 bytes)
    where the last dimension Q is a multiple of 4 and the leaf's and its
    output's bases are 16-byte aligned, else ``"scalar"``."""
    return "vector" if aligned and Q % 4 == 0 else "scalar"


def pack_leaves(n_outs, tile: int,
                max_leaves: int = MAX_LEAVES) -> list[list[tuple]]:
    """The launches that reduce leaves of ``n_outs`` output elements with
    tiles of ``tile`` elements: one list a launch of at most ``max_leaves``
    ``(leaf index, first tile, tiles)``, tiles numbered from 0 in leaf
    order.  Empty leaves take no tile and no entry."""
    out, cur, first = [], [], 0
    for i, n in enumerate(n_outs):
        if n == 0:
            continue
        if len(cur) == max_leaves:
            out.append(cur)
            cur, first = [], 0
        tiles = -(-n // tile)
        cur.append((i, first, tiles))
        first += tiles
    if cur:
        out.append(cur)
    return out


def _kernel_fn(name: str):
    if name not in _FNS:
        from repro_torch.kernels.build import build
        fn = getattr(build("dim_agg"), f"{name}_tree_launch")
        n_ptr = 2 if name == "dim_agg" else 3
        fn.argtypes = ([ctypes.POINTER(_Leaf), ctypes.c_int]
                       + [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 2
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
    if stacked[0].numel() >= 2 ** 31:
        raise ValueError(f"leaf {tuple(stacked.shape)}: the kernel takes "
                         "fewer than 2^31 output elements a leaf")
    r = stacked.shape[rank_axis]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    return r


def _operand(t: torch.Tensor, shape: tuple, name: str,
             like: torch.Tensor) -> torch.Tensor:
    """A small f32 operand, checked for shape and device."""
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, stacked on {like.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    return t.float().contiguous()


def _launch_tree(name: str, leaves, tile: int, args: tuple) -> list:
    """Reduce ``leaves`` (``(stacked, rank_axis)`` pairs, validated) in
    the launches of ``pack_leaves``; ``args`` are the shared operands after
    the table.  Returns the outputs in leaf order."""
    outs, table = [], []
    for stacked, ax in leaves:
        out = torch.empty(stacked.shape[1:], dtype=stacked.dtype,
                          device=stacked.device)
        vec = (name == "dim_agg" and dim_agg_route(
            stacked.shape[3], aligned16(stacked, out)) == "vector")
        outs.append(out)
        table.append((stacked, out, ax, vec))
    stream = torch.cuda.current_stream(leaves[0][0].device).cuda_stream
    for launch in pack_leaves([o.numel() for o in outs], tile):
        arr = (_Leaf * len(launch))()
        for slot, (i, first, tiles) in zip(arr, launch):
            stacked, out, ax, vec = table[i]
            _, _, P, Q = stacked.shape
            slot.x, slot.out = stacked.data_ptr(), out.data_ptr()
            slot.n_out, slot.P, slot.Q = out.numel(), P, Q
            slot.rank_axis, slot.vec = ax, int(vec)
            slot.tile0, slot.tiles = first, tiles
        err = _kernel_fn(name)(arr, len(launch), *args, stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError "
                               f"{err}")
        launches[name] += 1
        if name == "dim_agg":
            for i, _, _ in launch:
                leaves_by_route["vector" if table[i][3] else "scalar"] += 1
        else:
            K = leaves[0][0].shape[0]
            launches_by_clients[K] = launches_by_clients.get(K, 0) + 1
    return outs


def _shared_rank(leaves) -> tuple[int, int]:
    """Validate a tree's leaves for one launch: K and r shared, one CUDA
    device.  Returns (K, r)."""
    if not leaves:
        raise ValueError("no leaves to reduce")
    ranks = {_check_leaf(x, ax) for x, ax in leaves}
    ks = {x.shape[0] for x, _ in leaves}
    devs = {x.device for x, _ in leaves}
    if len(ranks) != 1 or len(ks) != 1 or len(devs) != 1:
        raise ValueError(f"leaves of one launch share K, r and the device: "
                         f"K {ks}, r {ranks}, devices {devs}")
    return ks.pop(), ranks.pop()


def dim_agg_tree_cuda(leaves, weights: torch.Tensor,
                      scale: torch.Tensor | None = None) -> list:
    """Launch ``dim_agg`` over the CUDA leaves ``[(stacked, rank_axis),
    ...]``, which share ``weights`` [K, r] and the optional ``scale`` [K]:
    one launch for up to ``MAX_LEAVES`` leaves.  Returns each leaf's
    layout without K."""
    K, r = _shared_rank(leaves)
    like = leaves[0][0]
    w = _operand(weights, (K, r), "weights", like)
    if scale is not None and tuple(scale.shape) == (K, 1):
        scale = scale[:, 0]                 # the Pallas operand's layout
    s = None if scale is None else _operand(scale, (K,), "scale", like)
    return _launch_tree("dim_agg", leaves, DIM_AGG_TILE,
                        (w.data_ptr(), None if s is None else s.data_ptr(),
                         K, r))


def dim_agg_trimmed_tree_cuda(leaves, p: torch.Tensor, cover: torch.Tensor,
                              t: torch.Tensor) -> list:
    """Launch ``dim_agg_trimmed`` over the CUDA leaves, which share the
    client weights ``p`` [K], coverage ``cover`` [K, r] and trim counts
    ``t`` [r]: one launch for up to ``MAX_LEAVES`` leaves."""
    K, r = _shared_rank(leaves)
    if K > MAX_CLIENTS:
        raise ValueError(f"{K} clients: the trimmed kernel takes at most "
                         f"{MAX_CLIENTS}")
    like = leaves[0][0]
    pw = _operand(p, (K,), "p", like)
    cov = _operand(cover, (K, r), "cover", like)
    tt = _operand(t, (r,), "t", like)
    return _launch_tree("dim_agg_trimmed", leaves, TRIMMED_TILE,
                        (pw.data_ptr(), cov.data_ptr(), tt.data_ptr(), K, r))


def dim_agg_cuda(stacked: torch.Tensor, weights: torch.Tensor,
                 scale: torch.Tensor | None = None, *,
                 rank_axis: int = 2) -> torch.Tensor:
    """Launch ``dim_agg`` on one stacked CUDA leaf (a one-entry table):
    ``weights`` [K, r], optional ``scale`` [K] → the leaf's layout without
    K."""
    return dim_agg_tree_cuda([(stacked, rank_axis)], weights, scale)[0]


def dim_agg_trimmed_cuda(stacked: torch.Tensor, p: torch.Tensor,
                         cover: torch.Tensor, t: torch.Tensor, *,
                         rank_axis: int = 2) -> torch.Tensor:
    """Launch ``dim_agg_trimmed`` on one stacked CUDA leaf: client weights
    ``p`` [K], coverage ``cover`` [K, r], trim counts ``t`` [r]."""
    return dim_agg_trimmed_tree_cuda([(stacked, rank_axis)], p, cover, t)[0]


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


def aggregate_leaves(leaves, weights: torch.Tensor,
                     scale: torch.Tensor | None = None) -> list:
    """FediLoRA Eq. 5 over leaves ``[(stacked, rank_axis), ...]`` that
    share w̃ [K, r]; ``scale`` [K] optionally multiplies each client's
    weight row (the FedBuff staleness discount or the clip factor).  One
    kernel launch on CUDA; the plain version on the CPU; either in a
    ``dim_agg`` span."""
    dev = leaves[0][0].device
    with span("dim_agg"):
        if dev.type == "cuda":
            return dim_agg_tree_cuda(leaves, weights, scale)
        if dev.type == "cpu":
            return [plain_dim_agg(x, weights, scale, rank_axis=ax)
                    for x, ax in leaves]
    raise ValueError(f"no dim_agg for device {dev}")


def trimmed_leaves(leaves, p: torch.Tensor, cover: torch.Tensor,
                   t: torch.Tensor) -> list:
    """Per-element trimmed weighted mean over leaves that share p, cover
    and t.  One kernel launch on CUDA; the plain version on the CPU;
    either in a ``dim_agg_trimmed`` span."""
    dev = leaves[0][0].device
    with span("dim_agg_trimmed"):
        if dev.type == "cuda":
            return dim_agg_trimmed_tree_cuda(leaves, p, cover, t)
        if dev.type == "cpu":
            return [plain_dim_agg_trimmed(x, p, cover, t, rank_axis=ax)
                    for x, ax in leaves]
    raise ValueError(f"no dim_agg_trimmed for device {dev}")


def dimension_wise_aggregate(stacked: torch.Tensor, weights: torch.Tensor,
                             scale: torch.Tensor | None = None, *,
                             rank_axis: int = 2) -> torch.Tensor:
    """FediLoRA Eq. 5 over one stacked leaf with w̃ [K, r]."""
    if rank_axis not in (2, 3):
        raise ValueError(f"rank_axis {rank_axis}: 2 (A layout) or 3 "
                         "(B layout)")
    return aggregate_leaves([(stacked, rank_axis)], weights, scale)[0]


def dimension_wise_trimmed(stacked: torch.Tensor, p: torch.Tensor,
                           cover: torch.Tensor, t: torch.Tensor, *,
                           rank_axis: int = 2) -> torch.Tensor:
    """Per-element trimmed weighted mean over one stacked leaf."""
    if rank_axis not in (2, 3):
        raise ValueError(f"rank_axis {rank_axis}: 2 (A layout) or 3 "
                         "(B layout)")
    return trimmed_leaves([(stacked, rank_axis)], p, cover, t)[0]


# ---------------------------------------------------------------------------
# tree functions (port of ``ops.py:97-209``): one launch per tree
# ---------------------------------------------------------------------------

def _global_rank(stacked_tree) -> int:
    return next(iter(stacked_tree.values()))["A"].shape[2]


def tree_leaves(stacked_tree) -> list:
    """A stacked LoRA tree's leaves in order, as ``(stacked, rank_axis)``:
    each module's A (rank rows) then B (rank columns)."""
    return [(e[m], 2 if m == "A" else 3) for e in stacked_tree.values()
            for m in ("A", "B")]


def _rebuild(stacked_tree, outs) -> dict:
    it = iter(outs)
    return {name: {m: next(it) for m in ("A", "B")} for name in stacked_tree}


def fedilora_aggregate_tree(stacked_tree, ranks, p):
    """Kernel-backed FediLoRA aggregation over a stacked LoRA tree."""
    from repro_torch.core.aggregation import dimension_wise_weights

    w = dimension_wise_weights(ranks, p, _global_rank(stacked_tree))
    return _rebuild(stacked_tree,
                    aggregate_leaves(tree_leaves(stacked_tree), w))


def discounted_aggregate_tree(stacked_tree, ranks, p, disc, anchor=None):
    """Kernel-backed discounted dimension-wise merge — the shared core of
    the FedBuff staleness merge and ``fedilora_clip``: the per-client
    discount ``disc`` [K] rides the kernel's ``scale`` operand, and the
    per-dimension mass it forfeits stays on ``anchor`` (an elementwise add
    after the kernel)."""
    from repro_torch.core.aggregation import dimension_wise_weights

    w = dimension_wise_weights(ranks, p, _global_rank(stacked_tree))
    out = _rebuild(stacked_tree,
                   aggregate_leaves(tree_leaves(stacked_tree), w, disc))
    if anchor is not None:
        covered = (w.sum(0) > 0).to(w.dtype)                   # [r_g]
        resid = covered * (1.0 - (w * disc[:, None]).sum(0))
        for name, e in out.items():
            r = resid.to(e["A"].dtype)
            e["A"] = e["A"] + r[None, :, None] * anchor[name]["A"]
            e["B"] = e["B"] + r[None, None, :] * anchor[name]["B"]
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
    return _rebuild(stacked_tree,
                    trimmed_leaves(tree_leaves(stacked_tree), p, cover, t))


__all__ = ["DIM_AGG_TILE", "MAX_CLIENTS", "MAX_LEAVES", "MAX_RANK",
           "TRIMMED_TILE", "aggregate_leaves", "dim_agg_cuda", "dim_agg_route",
           "dim_agg_tree_cuda", "dim_agg_trimmed_cuda",
           "dim_agg_trimmed_tree_cuda", "dimension_wise_aggregate",
           "dimension_wise_trimmed", "discounted_aggregate_tree",
           "fedbuff_aggregate_tree", "fedilora_aggregate_tree",
           "fedilora_clip_tree", "fedilora_trimmed_tree", "launches",
           "launches_by_clients", "leaves_by_route", "pack_leaves",
           "plain_dim_agg", "plain_dim_agg_trimmed", "reset_launches",
           "tree_leaves", "trimmed_leaves"]
