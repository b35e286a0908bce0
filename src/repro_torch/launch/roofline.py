"""Roofline terms at NVIDIA H100 constants, and the collective traffic of a
traced program (the port's counterpart of ``repro/launch/hlo_analysis.py``;
the port has no HLO to parse, so the module is named for what it holds).

The card is the NVIDIA H100 SXM5 80GB at its 700 W power limit.  Every
constant is a data-sheet figure, named with its source:

* ``PEAK_FLOPS`` — 989 TFLOP/s dense bf16 on the tensor cores (NVIDIA
  H100 Tensor Core GPU data sheet, SXM column, without sparsity);
* ``HBM_BW`` — 3.35 TB/s of HBM3 (same data sheet);
* ``HBM_BYTES`` — 80 GB of HBM3 (same data sheet), the budget a rank's
  arguments and temporaries must fit in;
* ``NVLINK_BW`` — 450 GB/s in each direction over NVLink 4 between the
  eight GPUs of one HGX H100 node (900 GB/s bidirectional, same data sheet);
* ``LINK_BW`` — 50 GB/s: one ConnectX-7 InfiniBand NDR port of 400 Gb/s
  for each GPU, the network between nodes (NVIDIA DGX H100 user guide).

The collective term divides by ``LINK_BW``, not ``NVLINK_BW``: every
16-wide axis of the 16×16 and 2×16×16 production meshes spans two or more
8-GPU nodes, so each ring of such an axis crosses the inter-node network,
and its slowest link sets the rate.  That ``LINK_BW`` equals the TPU v5e's
per-link ICI figure of the JAX package is a coincidence of two data sheets.

``PEAKS`` / :func:`peaks_for` hold the data-sheet rates of the cards the
on-card checks recognise by name (memory rate, bf16, f32 and TF32 peaks),
the one table both the roofline and the kernel bounds read.

:func:`collective_bytes` reads a :class:`repro_torch.launch.mesh.Mesh`'s
counters into the reference's schema: ``{"per_op": {op: bytes}, "counts":
{op: n}, "total_bytes": n}`` over the five op names of the reference.  Its
bytes are result bytes, as the reference sums result shapes: an all-reduce
moves its operand's size, an all-gather its operand's size times the axis
size, a reduce-scatter its operand's size over the axis size, an
all-to-all its operand's size.  The port issues no collective-permute, so
that stays 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

PEAK_FLOPS = 989e12          # dense bf16, H100 SXM5 data sheet
HBM_BW = 3.35e12             # bytes/s, H100 SXM5 data sheet
HBM_BYTES = 80e9             # bytes, H100 SXM5 80GB data sheet
NVLINK_BW = 450e9            # bytes/s one direction inside an 8-GPU node
LINK_BW = 50e9               # bytes/s, InfiniBand NDR 400 Gb/s per GPU

# (name fragment, bytes/s of device memory, dense bf16 tensor core, f32
# outside the tensor cores, dense TF32 tensor core), NVIDIA's data sheets;
# the first fragment found in a card's name wins
PEAKS = [("H200", 4.8e12, 989e12, 67e12, 495e12),
         ("H100 PCIe", 2.0e12, 756e12, 51e12, 378e12),
         ("H100", HBM_BW, PEAK_FLOPS, 67e12, 495e12)]

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
_PORT_OPS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


def peaks_for(name: str):
    """Memory rate, bf16 peak and the peak that bounds f32 work: the f32
    CUDA-core peak or a third of the TF32 peak, whichever is larger (the
    3xTF32 route runs three TF32 products for each f32 one)."""
    for key, bw, bf16, f32, tf32 in PEAKS:
        if key in name:
            return bw, bf16, max(f32, tf32 / 3)
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def axis_size(shape: dict, axis) -> int:
    """The size of ``axis`` (a name or a tuple of names) in a mesh's
    ``{axis: size}``."""
    axes = axis if isinstance(axis, tuple) else (axis,)
    return math.prod(shape[a] for a in axes)


def collective_bytes(mesh, counts=None, nbytes=None) -> dict:
    """The reference's collective schema from ``mesh``'s counters (or from
    ``counts`` / ``nbytes``, Counters keyed ``(op, axis)`` like the mesh's:
    operand bytes, e.g. scaled from a partial trace)."""
    counts = mesh.collectives if counts is None else counts
    nbytes = mesh.collective_bytes if nbytes is None else nbytes
    per_op = {k: 0 for k in COLLECTIVE_OPS}
    n = {k: 0 for k in COLLECTIVE_OPS}
    for (op, axis), c in counts.items():
        name = _PORT_OPS[op]
        n_ax, b = axis_size(mesh.shape, axis), nbytes[(op, axis)]
        per_op[name] += (b * n_ax if op == "all_gather" else
                         b // n_ax if op == "reduce_scatter" else b)
        n[name] += c
    return {"per_op": per_op, "counts": n,
            "total_bytes": sum(per_op.values())}


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    coll_bytes: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
        }


def roofline(cost_analysis: dict, coll: dict) -> RooflineTerms:
    """The three terms of one rank's program: ``cost_analysis`` holds
    ``"flops"`` and ``"bytes accessed"``, ``coll`` the schema of
    :func:`collective_bytes`."""
    flops = float(cost_analysis.get("flops", 0.0))
    hbm = float(cost_analysis.get("bytes accessed", 0.0))
    cb = float(coll["total_bytes"])
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=hbm / HBM_BW,
        collective_s=cb / LINK_BW,
        flops=flops, hbm_bytes=hbm, coll_bytes=cb,
    )


__all__ = ["COLLECTIVE_OPS", "HBM_BW", "HBM_BYTES", "LINK_BW", "NVLINK_BW",
           "PEAKS", "PEAK_FLOPS", "RooflineTerms", "axis_size",
           "collective_bytes", "peaks_for", "roofline"]
