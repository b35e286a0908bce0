"""Fused LoRA projection,

    y = x @ W + scale * (x @ Aᵀ) @ Bᵀ,

with x [..., K], W [K, N], A [r, K] and B [N, r].

Port of ``repro.kernels.ops.fused_lora_matmul`` + the Pallas kernel
``lora_matmul_pallas`` (``kernels/lora_matmul.py``).  On a CUDA tensor the
wrapper launches the hand-written Hopper kernel (``csrc/lora_matmul.cu``,
built by ``build.py`` at first use) or raises; on a CPU tensor it computes
the plain version ``ref.lora_matmul_ref``.  ``launches`` counts kernel
launches.  The kernel masks ragged edges itself, so no operand is padded.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import lora_matmul_ref

#: kernel launches since the last reset (CPU calls never count)
launches = 0
#: the kernel keeps ceil(r / 16) ranks of x @ Aᵀ per thread, at most 8
MAX_RANK = 128
#: rows of one block of the kernel; the grid holds at most 65535 row tiles
_ROWS_PER_BLOCK = 64
_DTYPES = (torch.float32, torch.bfloat16)
_FN = None


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel_fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import build
        fn = build("lora_matmul").lora_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def lora_matmul_cuda(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """Launch the kernel on 2-D operands: x [M, K], w [K, N], a [r, K],
    b [N, r] — all on one CUDA device and contiguous."""
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
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    err = _kernel_fn()(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        M, K, N, r, float(scale), int(x.dtype == torch.bfloat16),
        int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lora_matmul kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
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


__all__ = ["MAX_RANK", "fused_lora_matmul", "launches", "lora_matmul_cuda",
           "reset_launches"]
