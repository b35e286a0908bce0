"""Fused LoRA projection,

    y = x @ W + scale * (x @ Aᵀ) @ Bᵀ,

with x [..., K], W [K, N], A [r, K] and B [N, r].

Port of ``repro.kernels.ops.fused_lora_matmul`` + the Pallas kernel
``lora_matmul_pallas`` (``kernels/lora_matmul.py``).  On a CUDA tensor the
wrapper launches one of two hand-written Hopper kernels (built by
``build.py`` at first use) or raises; on a CPU tensor it computes the plain
version ``ref.lora_matmul_ref``.  ``lora_route`` picks the kernel from the
dtypes, the shapes and whether the operands' bases are 16-byte aligned
(``build.aligned16``, read from ``data_ptr()`` by the wrapper):

* ``"wgmma"`` (``csrc/lora_matmul_wgmma.cu``): bf16 x/W with bf16 A/B on
  the tensor cores, fed by TMA.  TMA needs every row stride and base
  address to be a multiple of 16 bytes, so K, N and r must be multiples
  of 8, K >= 1, and x, W, A and B aligned;
* ``"tf32x3"`` (``csrc/lora_matmul.cu``): every other call — f32, the two
  mixed dtype pairs, and bf16 whose strides or bases TMA refuses (such as
  a contiguous view at an odd element offset) — on the tensor cores in
  3xTF32 (each f32 operand split into two TF32 values, three products),
  held to the f32 limit.

A failed launch raises; it is never retried on the other route.
``launches`` counts kernel launches on both routes, ``launches_by_route``
each route's.  Both kernels take ragged edges themselves (TMA's zero fill,
or masked loads), so no operand is padded.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import aligned16
from repro_torch.kernels.ref import lora_matmul_ref

#: kernel launches since the last reset (CPU calls never count)
launches = 0
#: the same, per route
launches_by_route = {"wgmma": 0, "tf32x3": 0}
#: widest rank the kernels take (x @ Aᵀ is at most 128 columns of
#: accumulators)
MAX_RANK = 128
#: rows of one block of the 3xTF32 kernel (the tensor-core kernel's are
#: 128); the grid holds at most 65535 row tiles
_ROWS_PER_BLOCK = 64
_DTYPES = (torch.float32, torch.bfloat16)
_FN: dict = {}


def reset_launches() -> None:
    global launches
    launches = 0
    for route in launches_by_route:
        launches_by_route[route] = 0


def lora_route(x_dtype: torch.dtype, a_dtype: torch.dtype, M: int, K: int,
               N: int, r: int, aligned: bool) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bf16 x/W and A/B whose
    tensor maps TMA takes (K, N and r multiples of 8, so that the row
    strides K·2, N·2 and r·2 are multiples of 16 bytes, K >= 1, and
    ``aligned``: every operand's base a multiple of 16 bytes), else
    ``"tf32x3"``."""
    del M   # the row count enters no stride
    if (x_dtype == torch.bfloat16 and a_dtype == torch.bfloat16 and K >= 1
            and K % 8 == 0 and N % 8 == 0 and r % 8 == 0 and aligned):
        return "wgmma"
    return "tf32x3"


def _kernel_fn(route: str):
    if route not in _FN:
        from repro_torch.kernels.build import build
        if route == "wgmma":
            fn = build("lora_matmul_wgmma").lora_matmul_wgmma_launch
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_void_p])
        else:
            fn = build("lora_matmul").lora_matmul_launch
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN[route] = fn
    return _FN[route]


def lora_matmul_cuda(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """Launch the kernel of ``lora_route``'s route on 2-D operands: x
    [M, K], w [K, N], a [r, K], b [N, r] — all on one CUDA device and
    contiguous, at any base address."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    M, K = x.shape
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x/w dtypes {x.dtype}/{w.dtype}: need one of "
                        f"{_DTYPES}, equal")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a/b dtypes {a.dtype}/{b.dtype}: need one of "
                        f"{_DTYPES}, equal")
    if w.dim() != 2 or w.shape[0] != K or a.dim() != 2 or a.shape[1] != K:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"a {tuple(a.shape)} do not agree")
    N, r = w.shape[1], a.shape[0]
    if tuple(b.shape) != (N, r):
        raise ValueError(f"b shape {tuple(b.shape)}, expected {(N, r)}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    if -(-M // _ROWS_PER_BLOCK) > 65535 or max(K, N) >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)} w {tuple(w.shape)} too large "
                         "for the kernel's grid")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} on {t.device}: the kernel needs every "
                             "operand on one CUDA device")
    route = lora_route(x.dtype, a.dtype, M, K, N, r, aligned16(x, w, a, b))
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    ptrs = (x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "wgmma":
        err = _kernel_fn(route)(*ptrs, M, K, N, r, float(scale), stream)
    else:
        err = _kernel_fn(route)(*ptrs, M, K, N, r, float(scale),
                                int(x.dtype == torch.bfloat16),
                                int(a.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"lora_matmul kernel launch failed on the "
                           f"{route} route: cudaError {err}")
    launches += 1
    launches_by_route[route] += 1
    return y


def fused_lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """``y = x@W + scale·(x@Aᵀ)@Bᵀ`` over x [..., K] with any leading batch
    dims; w [K, N]; a [r, K]; b [N, r].  Returns [..., N] in the dtype of
    x."""
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = lora_matmul_ref(x2, w, a, b, scale=scale)
    elif x.device.type == "cuda":
        y = lora_matmul_cuda(x2, w, a, b, scale=scale)
    else:
        raise ValueError(f"no fused_lora_matmul for device {x.device}")
    return y.reshape(*lead, w.shape[1])


__all__ = ["MAX_RANK", "fused_lora_matmul", "launches", "launches_by_route",
           "lora_matmul_cuda", "lora_route", "reset_launches"]
