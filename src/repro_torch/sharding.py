"""Partition rules (port of ``repro/sharding.py``): which mesh axis each
dimension of a parameter, an adapter, a batch or a decode cache is split
over.

The rules read only ``mesh.shape`` (a mapping from axis name to size) and
``mesh.axis_names``, so they hold for ``repro_torch.launch.mesh.Mesh`` and
for any stand-in with those two attributes.  A spec is a :class:`P`, a
tuple of axis names (``None``: not split; a tuple of names: split over
their product), equal as a tuple to the reference's
``jax.sharding.PartitionSpec``.

Mesh axes: ``("data", "model")`` on one pod, ``("pod", "data", "model")``
on two; a federated round mesh is ``(client,)`` or ``(client, "model")``
and a serving mesh ``("data",)`` or ``("data", "model")``.

* weights: tensor-parallel over ``"model"`` on the parallel matmul
  dimension, FSDP over ``"data"`` on the other large one
  (:func:`param_spec`), or tensor-parallel only (:func:`param_spec_tp`,
  for meshes whose ``"data"`` axis holds clients or serving slots);
* LoRA adapters, norms, biases and small tables: replicated;
* batches over ``("pod", "data")`` when they divide; a decode cache's
  batch rows likewise, else its sequence over ``"data"``;
* every rule degrades axis by axis to replication where a dimension does
  not divide its axis, or the mesh lacks the axis.

:func:`shard_local` gives one rank's contiguous piece of a tensor under a
spec.  The rules decide only by divisibility and by a weight's name; the
port's tensor-parallel execution (``repro_torch.models.tensor_parallel``)
keeps whole heads (attention, MLA, SSM heads) or whole expert columns on
each rank, keeps a sublayer whole where they do not divide, and places
these otherwise than the rules:

* attention's K/V heads where they are fewer than the ``"model"`` axis:
  each rank holds one, shared by ``n / num_kv_heads`` ranks (the rules
  split ``wk`` / ``wv`` into ``head_dim`` blocks); the attention biases
  by heads, not replicated;
* Mamba's ``in_proj`` ``[d, z | xs | B | C | dt]`` and its conv channels
  ``[xs | B | C]``: cut segment by segment (``z``, ``xs``, ``dt`` by
  heads, the one group's ``B`` / ``C`` whole on every rank), not into
  contiguous column blocks; ``A_log``, ``D``, ``dt_bias``, ``gate_norm``
  and ``conv_b`` split by heads, not replicated;
* the Mamba decode cache: ``h`` ``[n, B, H, P, N]`` over its heads and
  ``conv`` ``[n, B, W-1, C]`` by the same segment cut, where
  :func:`cache_spec` splits the trailing dimension (N, or C in contiguous
  blocks); the attention K/V cache by KV heads, not by ``head_dim``;
  MLA's ``c_kv`` / ``k_rope`` whole (``wdq`` and ``wkv_a`` stay whole);
* the enc-dec frontend ``encoder.in_proj`` whole over ``"model"``,
  though its name is Mamba's;
* a ``seq`` cache (``cache_spec(mode="seq")``) holds every K/V head of its
  ``S / model`` positions, as the rule says; the static cross caches keep
  their baseline placement.

The ``"data"`` components of :func:`param_spec` are the port's FSDP
pieces (``TensorParallel(fsdp=True)``), and :func:`decode_cache_axis`
names the axis a decode cache's sequence splits over.
"""

from __future__ import annotations

import math

# weight-name classification: which dim is tensor-parallel ("model")
_UP_LIKE = {"wq", "wk", "wv", "w1", "w3", "wdq", "wuq", "wkv_a", "wkv_b",
            "in_proj", "vision_proj"}
_DOWN_LIKE = {"wo", "w2", "out_proj"}
_REPLICATED = {"ln1", "ln2", "lnx", "final_ln", "gate", "gate_norm", "A_log",
               "D", "dt_bias", "bq", "bk", "bv", "conv_b", "router"}
_MOE_EXPERT_WEIGHTS = {"w1", "w3", "w2"}
_SEQ_CACHES = ("k", "v", "c_kv", "k_rope")


class P(tuple):
    """A partition spec: one entry per leading dimension (an axis name, a
    tuple of names, or ``None``); missing trailing entries are ``None``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_size(mesh, axis) -> int:
    """Product of the named axes' sizes; axes absent from the mesh count as
    1 (the rule then degrades through :func:`fit_spec`, which drops them)."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape.get(a, 1) for a in axis)
    return mesh.shape.get(axis, 1)


def _axes_in_mesh(mesh, axis) -> bool:
    if axis is None:
        return True
    names = mesh.axis_names
    if isinstance(axis, tuple):
        return all(a in names for a in axis)
    return axis in names


def fit_spec(mesh, shape: tuple, spec: tuple) -> P:
    """Drop the split of every dimension its axis does not divide, and of
    every axis the mesh does not carry; a short spec is padded with
    ``None`` to the tensor's rank."""
    out = []
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, axis in zip(shape, padded):
        ok = _axes_in_mesh(mesh, axis) and dim % _axis_size(mesh, axis) == 0
        out.append(axis if ok else None)
    return P(*out)


def _data_axis(mesh):
    return "data" if "data" in mesh.axis_names else None


def param_spec(path: tuple, shape: tuple, mesh, mode: str = "baseline") -> P:
    """The spec of one parameter, by its tree path and shape.

    ``mode="baseline"``: tensor-parallel over ``"model"``, FSDP over
    ``"data"``; ``"ep"``: MoE expert weights split their expert dimension
    over ``"data"`` and their ff dimension over ``"model"``."""
    name = str(path[-1])
    da = _data_axis(mesh)

    if name in _REPLICATED or len(shape) <= 1:
        return P()
    if name == "embed":                       # [V, d]
        return fit_spec(mesh, shape, P("model", da))
    if name == "unembed":                     # [d, V]
        return fit_spec(mesh, shape, P(da, "model"))
    if name == "conv_w":                      # [n, W, C]
        return fit_spec(mesh, shape, P(None, None, "model"))

    # MoE expert weights: [n, E, in, out]
    is_expert = name in _MOE_EXPERT_WEIGHTS and len(shape) == 4
    if is_expert and mode == "ep":
        if name == "w2":
            return fit_spec(mesh, shape, P(None, da, "model", None))
        return fit_spec(mesh, shape, P(None, da, None, "model"))

    # stacked-by-blocks weights carry a leading scan dim; MoE an expert dim
    prefix = (None,) * (len(shape) - 2)       # dims before [in, out]
    if name in _UP_LIKE:
        return fit_spec(mesh, shape, P(*prefix, da, "model"))
    if name in _DOWN_LIKE:
        return fit_spec(mesh, shape, P(*prefix, "model", da))
    return P()


def param_spec_tp(path: tuple, shape: tuple, mesh,
                  mode: str = "baseline") -> P:
    """:func:`param_spec` without its ``"data"`` component: tensor-parallel
    over ``"model"`` only.  For meshes whose ``"data"``-named axis holds
    serving slots or clients, where splitting a frozen weight over it would
    gather the weight at every use."""
    def _strip_data(ax):
        if ax == "data":
            return None
        if isinstance(ax, tuple):          # keep the non-"data" components
            kept = tuple(a for a in ax if a != "data")
            return kept[0] if len(kept) == 1 else (kept or None)
        return ax

    spec = param_spec(path, shape, mesh, mode)
    return fit_spec(mesh, shape, P(*[_strip_data(ax) for ax in spec]))


def lora_spec(path: tuple, shape: tuple, mesh, mode: str = "baseline") -> P:
    """LoRA adapters replicate: they are the objects the server aggregates,
    and small beside the base weights."""
    return P()


def batch_axes(mesh):
    """Axes the global batch splits over (pod first, then data)."""
    names = [a for a in ("pod", "data") if a in mesh.axis_names]
    return tuple(names) if names else None


def batch_spec(shape: tuple, mesh, *, seq_axis: int | None = None) -> P:
    """Dimension 0 (the batch) over ``("pod", "data")`` when it divides;
    otherwise, given ``seq_axis``, that dimension over ``"data"``; else
    replicated."""
    ba = batch_axes(mesh)
    if ba is None:
        return P()
    bsz = math.prod(mesh.shape[a] for a in ba)
    if shape[0] % bsz == 0 and shape[0] >= bsz:
        spec = [None] * len(shape)
        spec[0] = ba if len(ba) > 1 else ba[0]
        return P(*spec)
    if seq_axis is not None and shape[seq_axis] % mesh.shape["data"] == 0:
        spec = [None] * len(shape)
        spec[seq_axis] = "data"
        return P(*spec)
    return P()


def cache_spec(path: tuple, shape: tuple, mesh, mode: str = "baseline") -> P:
    """A decode cache leaf ``[n_blocks, B, S, ...features]``.

    ``baseline``: batch over ``("pod", "data")`` when it divides (else the
    sequence over ``"data"``), the trailing feature dimension over
    ``"model"``.  ``seq``: batch over ``("pod", "data")``, the sequence of
    the K/V and latent caches over ``"model"``."""
    da = batch_axes(mesh)
    name = str(path[-1])
    spec = [None] * len(shape)
    bsz = math.prod(mesh.shape[a] for a in da) if da else 1
    batch_ok = bool(len(shape) >= 2 and da and shape[1] % bsz == 0
                    and shape[1] >= bsz)
    if batch_ok:
        spec[1] = da if len(da) > 1 else da[0]
    if name in _SEQ_CACHES and len(shape) >= 3:
        if mode == "seq" and shape[2] % _axis_size(mesh, "model") == 0:
            spec[2] = "model"
        elif not batch_ok and "data" in mesh.axis_names \
                and shape[2] % mesh.shape["data"] == 0:
            spec[2] = "data"
    if mode != "seq" and shape[-1] % _axis_size(mesh, "model") == 0 \
            and shape[-1] > 1:
        spec[-1] = "model"
    return fit_spec(mesh, shape, P(*spec))


def global_rows(B: int, n: int, dp: int, coord: int) -> list:
    """The global rows of a batch of ``B`` that the rank at ``coord`` of
    ``dp`` batch-sharded ranks holds, in its own order, when a step splits
    the batch into ``n`` microbatches: the reference's microbatch ``i`` is
    global rows ``[i·B/n, (i+1)·B/n)``, and this rank holds block
    ``coord`` of each, so its own microbatch ``i`` (its local rows ``[i·B/
    (n·dp), (i+1)·B/(n·dp))``) is its share of the reference's."""
    if B % (n * dp):
        raise ValueError(f"a batch of {B} does not split into {n} "
                         f"microbatches over {dp} ranks")
    mb, loc = B // n, B // (n * dp)
    return [i * mb + coord * loc + j for i in range(n) for j in range(loc)]


def decode_cache_axis(mesh, batch: int, seq: int,
                      mode: str = "baseline"):
    """The axis a decode cache's sequence splits over, by
    :func:`cache_spec`'s rules: ``"model"`` under ``mode="seq"`` (when it
    divides the sequence), ``"data"`` when the batch does not divide the
    batch axes (the long-context fallback), else ``None``."""
    ba = batch_axes(mesh)
    bsz = math.prod(mesh.shape[a] for a in ba) if ba else 1
    batch_ok = bool(ba) and batch % bsz == 0 and batch >= bsz
    if mode == "seq" and "model" in mesh.axis_names \
            and seq % mesh.shape["model"] == 0:
        return "model"
    if not batch_ok and "data" in mesh.axis_names \
            and seq % mesh.shape["data"] == 0:
        return "data"
    return None


def round_mesh_axes(mesh) -> tuple:
    """``(client_axis, model_axis)`` of a federated round mesh: a 1-D mesh
    (any axis name) is all client axis, ``(None)`` model axis; a 2-D mesh
    whose last axis is ``"model"`` splits clients over its first.  Any
    other mesh raises."""
    names = tuple(mesh.axis_names)
    if len(names) == 1:
        return names[0], None
    if len(names) == 2 and names[1] == "model" and names[0] != "model":
        return names[0], "model"
    raise ValueError(
        f"round mesh must be 1-D (client axis) or 2-D with axes "
        f"(client, 'model'); got axes {names}")


def shard_local(tensor, spec: tuple, mesh):
    """This rank's piece of ``tensor`` under ``spec``: along each split
    dimension the contiguous block at the rank's coordinate on the axis
    (axis tuples are row-major, their first axis outermost), returned
    contiguous.  ``mesh`` must know this rank's coordinates
    (``mesh.coord(axis)``)."""
    out = tensor
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        n, i = 1, 0
        for a in axes:
            i = i * mesh.shape[a] + mesh.coord(a)
            n *= mesh.shape[a]
        size = out.shape[dim] // n
        out = out.narrow(dim, i * size, size)
    return out.contiguous()


__all__ = ["P", "batch_axes", "batch_spec", "cache_spec",
           "decode_cache_axis", "fit_spec", "global_rows", "lora_spec", "param_spec", "param_spec_tp", "round_mesh_axes",
           "shard_local"]
