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

Every collective goes through a :class:`Mesh` method, which counts its
calls, its operand bytes and its largest operand by ``(op, axis)`` in
``mesh.collectives``, ``mesh.collective_bytes`` and
``mesh.collective_largest`` (``reset_collectives`` clears them; an
operand is this rank's input): the port's analogue of the reference's
checks of the collectives in its compiled programs.  Work that runs
without a mesh never reaches this module.
"""

from __future__ import annotations

import collections
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


class Mesh:
    """A named device mesh over the process group.

    ``shape``: ``{axis: size}`` in axis order; ``axis_names``; ``device``:
    this rank's device.  ``group(axis)`` is the process group of the ranks
    that differ from this one only along ``axis``, and ``coord(axis)``
    this rank's index along it."""

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
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.collectives: collections.Counter = collections.Counter()
        self.collective_bytes: collections.Counter = collections.Counter()
        self.collective_largest: dict = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"

    def group(self, axis: str):
        return self._groups[axis]

    def coord(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def reset_collectives(self) -> None:
        self.collectives.clear()
        self.collective_bytes.clear()
        self.collective_largest.clear()

    def _count(self, op: str, axis: str, t: torch.Tensor) -> None:
        key, nbytes = (op, axis), t.numel() * t.element_size()
        self.collectives[key] += 1
        self.collective_bytes[key] += nbytes
        self.collective_largest[key] = max(self.collective_largest.get(
            key, 0), nbytes)

    # --------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over ``axis`` (``op``: sum or max);
        returns ``t``."""
        self._count("all_reduce", axis, t)
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in
        coordinate order."""
        self._count("all_gather", axis, t)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=self.group(axis))
        return torch.cat(parts, dim=dim)

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
