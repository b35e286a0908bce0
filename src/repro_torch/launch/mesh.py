"""Device meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``).

The port runs a mesh as SPMD processes, one rank per device: every rank
runs the same host code (sampling, fault draws, the scheduler, the
engine's admission loop — all seeded numpy, so the ranks agree bit for
bit) and the ranks exchange only tensors, through the collectives of
:class:`Mesh`.  A process joins with :func:`init_distributed`, which picks
the backend from the device: NCCL for CUDA, gloo for a CPU caller that
passes ``device="cpu"``.  A mesh's axis groups come from
``torch.distributed.device_mesh.init_device_mesh`` under the reference's
axis names, and a mesh spans every rank of the process group, row-major
(the last axis varies fastest).

An axis argument is an axis name or a tuple of names, e.g. ``("pod",
"data")``: the tuple is the flattened axis, row-major in the tuple's order
(its first name outermost), so the 2×16×16 mesh's batch axes form one
32-rank group.

Every collective (all-reduce, all-gather, reduce-scatter, all-to-all) goes
through a :class:`Mesh` method, which counts its calls, its operand bytes
and its largest operand by ``(op, axis)`` in
``mesh.collectives``, ``mesh.collective_bytes`` and
``mesh.collective_largest`` (``reset_collectives`` clears them; an
operand is this rank's input): the port's analogue of the reference's
checks of the collectives in its compiled programs.  Work that runs
without a mesh never reaches this module.
"""

from __future__ import annotations

import collections
import itertools
import math

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def init_distributed(backend: str | None = None, *, init_method: str,
                     world_size: int, rank: int, device=None) -> torch.device:
    """Join this process to the process group and return its device.

    ``device``: ``None`` means CUDA (raises without it), in which case the
    rank takes ``cuda:<rank>`` (one host) and the backend is NCCL; with
    ``device="cpu"`` the backend is gloo.  ``backend``, if given, must be
    that one: it is never switched.  ``init_method``: e.g.
    ``"file:///path/to/rendezvous"`` or ``"tcp://localhost:29500"``."""
    dev = resolve_device(device)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend is not None and backend != want:
        raise ValueError(f"backend {backend!r} does not serve {dev.type} "
                         f"tensors; the port uses {want!r} there")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(want, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


class _CopyToAxis(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward: the input of
    a column-parallel product, whose gradient is a partial sum on each
    rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axis), None, None


class _ReduceFromAxis(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a row-parallel
    product.  Every rank computes the same loss from the reduced value, so
    each rank's partial sum takes that loss's gradient as it is (the
    all-reduce of ``torch.distributed.nn.functional`` would reduce it
    again, counting the one loss once per rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumOverAxis(torch.autograd.Function):
    """All-reduce forward and backward: a sum of partial values that each
    rank goes on to use in its own partial computation, so the sum's
    gradient is itself a partial sum on each rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), ctx.axis), \
            None, None


class _GatherSeq(torch.autograd.Function):
    """All-gather of ``dim`` forward, reduce-scatter of the gradient
    backward: the sequence-parallel input of a sublayer whose consumers on
    each rank contribute a partial gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axis, dim=ctx.dim), None, \
            None, None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter of ``dim`` forward, all-gather of the gradient
    backward: a row-parallel output's partial sums, summed and left as
    this rank's rows (the dual of :class:`_GatherSeq`)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.reduce_scatter(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, dim=ctx.dim), None, None, \
            None


class _GatherSlice(torch.autograd.Function):
    """All-gather of ``dim`` forward, this rank's slice of the gradient
    backward: the gathered tensor's consumers hold the whole gradient on
    every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n, c = ctx.mesh.shape[ctx.axis], ctx.mesh.coord(ctx.axis)
        size = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, c * size, size), None, None, None


class _AllToAll(torch.autograd.Function):
    """All-to-all over dimension 0 forward (block ``j`` to coordinate
    ``j``), the reverse exchange backward (the same all-to-all: the
    exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, ctx.axis), None, None


def _axis_key(axis):
    """An axis argument as the counters and the groups key it: a name, or
    a tuple of two or more names (a one-name tuple is the name)."""
    if isinstance(axis, tuple):
        return axis[0] if len(axis) == 1 else axis
    return axis


class _Shape(dict):
    """``{axis: size}`` that also answers a tuple of axes with the size of
    the flattened axis."""

    def __missing__(self, key):
        if isinstance(key, tuple):
            return math.prod(self[a] for a in key)
        raise KeyError(key)


class Mesh:
    """A named device mesh over the process group.

    ``shape``: ``{axis: size}`` in axis order (a tuple of axes also
    answers, with their product); ``axis_names``; ``device``: this rank's
    device.  ``group(axis)`` is the process group of the ranks that differ
    from this one only along ``axis`` (a name or a tuple of names), and
    ``coord(axis)`` this rank's index along it."""

    def __init__(self, shape: tuple, axis_names: tuple):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             "in length")
        need = math.prod(shape)
        have = dist.get_world_size() if dist.is_initialized() else 0
        if have != need:
            raise ValueError(
                f"a mesh of shape {tuple(shape)} needs {need} devices, have "
                f"{have} (a mesh spans every rank of the process group; "
                "start one process per device and call init_distributed)")
        backend = dist.get_backend()
        kind = "cuda" if backend == "nccl" else "cpu"
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if kind == "cuda" else torch.device("cpu"))
        from torch.distributed.device_mesh import init_device_mesh
        self.device_mesh = init_device_mesh(kind, tuple(shape),
                                            mesh_dim_names=tuple(axis_names))
        self.axis_names = tuple(axis_names)
        self._groups = {a: self.device_mesh.get_group(a)
                        for a in self.axis_names}
        self.shape = _Shape(zip(self.axis_names, (int(s) for s in shape)))
        self.collectives: collections.Counter = collections.Counter()
        self.collective_bytes: collections.Counter = collections.Counter()
        self.collective_largest: dict = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"

    def group(self, axis):
        axis = _axis_key(axis)
        if axis not in self._groups:
            self._groups[axis] = self._flat_group(axis)
        return self._groups[axis]

    def _flat_group(self, axes: tuple):
        """The group of a tuple of axes, made the first time it is asked
        for (every rank asks at the same point of the SPMD program): one
        group for each coordinate on the other axes, its ranks in
        row-major order over ``axes``."""
        if len(set(axes)) != len(axes) or any(
                a not in self.shape for a in axes):
            raise ValueError(f"axes {axes} are not distinct axes of "
                             f"{self.axis_names}")
        sizes = [self.shape[a] for a in self.axis_names]
        others = [a for a in self.axis_names if a not in axes]
        groups = {}
        for coords in itertools.product(*(range(n) for n in sizes)):
            at = dict(zip(self.axis_names, coords))
            rank = 0
            for a, n in zip(self.axis_names, sizes):
                rank = rank * n + at[a]
            key = tuple(at[a] for a in others)
            groups.setdefault(key, []).append(
                (tuple(at[a] for a in axes), rank))
        ranks = [[r for _, r in sorted(g)] for _, g in sorted(groups.items())]
        group, _ = dist.new_subgroups_by_enumeration(ranks)
        return group

    def coord(self, axis) -> int:
        axis = _axis_key(axis)
        if not isinstance(axis, tuple):
            return self.device_mesh.get_local_rank(axis)
        c = 0
        for a in axis:
            c = c * self.shape[a] + self.device_mesh.get_local_rank(a)
        return c

    def reset_collectives(self) -> None:
        self.collectives.clear()
        self.collective_bytes.clear()
        self.collective_largest.clear()

    def _count(self, op: str, axis, t: torch.Tensor) -> None:
        key, nbytes = (op, _axis_key(axis)), t.numel() * t.element_size()
        self.collectives[key] += 1
        self.collective_bytes[key] += nbytes
        self.collective_largest[key] = max(self.collective_largest.get(
            key, 0), nbytes)

    # --------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor, axis,
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over ``axis`` (``op``: sum or max);
        returns ``t``."""
        self._count("all_reduce", axis, t)
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in
        coordinate order."""
        self._count("all_gather", axis, t)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=self.group(axis))
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, t: torch.Tensor, axis,
                       dim: int = 0) -> torch.Tensor:
        """The sum of every rank's ``t`` over ``axis``, of which this rank
        keeps block ``coord(axis)`` along ``dim``."""
        self._count("reduce_scatter", axis, t)
        n = self.shape[axis]
        dim = dim % t.dim()
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        # torch 2.13 marks this name deprecated in favour of
        # reduce_scatter_single, which older releases lack
        dist.reduce_scatter_tensor(out, src, group=self.group(axis))
        return out.movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, axis) -> torch.Tensor:
        """Block ``j`` of ``t``'s dimension 0 (``shape[axis]`` equal
        blocks) to the rank at coordinate ``j``; returns the blocks this
        rank received, block ``s`` from coordinate ``s``."""
        self._count("all_to_all", axis, t)
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group(axis))
        return out

    def copy_to(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Autograd: identity, gradient all-reduced over ``axis``."""
        return _CopyToAxis.apply(x, self, axis)

    def reduce_from(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Autograd: all-reduce (sum) over ``axis``, gradient as it is."""
        return _ReduceFromAxis.apply(x, self, axis)

    def sum_over(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Autograd: all-reduce (sum) over ``axis``, gradient all-reduced
        too."""
        return _SumOverAxis.apply(x, self, axis)

    def gather_seq(self, x: torch.Tensor, axis, dim: int = 1,
                   grad: str = "reduce_scatter") -> torch.Tensor:
        """Autograd: all-gather of ``dim`` over ``axis``; the gradient is
        reduce-scattered (``grad="reduce_scatter"``: each rank's consumers
        give a partial gradient) or sliced (``"slice"``: they give the
        whole one)."""
        fn = _GatherSeq if grad == "reduce_scatter" else _GatherSlice
        return fn.apply(x, self, axis, dim)

    def scatter_seq(self, x: torch.Tensor, axis, dim: int = 1) -> torch.Tensor:
        """Autograd: reduce-scatter of ``dim`` over ``axis``, gradient
        all-gathered."""
        return _ScatterSeq.apply(x, self, axis, dim)

    def exchange(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Autograd: :meth:`all_to_all`, the gradient sent back the same
        way."""
        return _AllToAll.apply(x, self, axis)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 ranks on one pod, 2×16×16 = 512 across two."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> Mesh:
    """A small ``("data", "model")`` mesh for tests."""
    return Mesh((n_data, n_model), ("data", "model"))


def make_round_mesh(n_client: int, n_model: int = 1) -> Mesh:
    """The mesh of ``FederatedTrainer(mesh=...)``: sampled clients split
    over ``"client"`` (``n_client`` groups), each group's local training
    tensor-parallel over ``"model"`` (``n_model`` ranks).  ``n_model=1``
    gives the 1-D client mesh.  Needs ``n_client * n_model`` ranks."""
    if n_model == 1:
        return Mesh((n_client,), ("client",))
    return Mesh((n_client, n_model), ("client", "model"))


__all__ = ["Mesh", "init_distributed", "make_debug_mesh",
           "make_production_mesh", "make_round_mesh"]
