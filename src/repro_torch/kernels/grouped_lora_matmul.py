"""Multi-tenant LoRA projection (BGMV): row ``m`` of ``x`` applies adapter
``idx[m]`` of a stacked bank,

    y[m] = x[m] @ W + scale * (x[m] @ A[idx[m]]ᵀ) @ B[idx[m]]ᵀ.

Port of ``repro.kernels.ops.grouped_lora_matmul`` + the Pallas kernel
``grouped_lora_matmul_pallas`` (``kernels/lora_gather_matmul.py``).  On a
CUDA tensor the wrapper launches the hand-written Hopper kernels
(``csrc/grouped_lora_matmul.cu``, built by ``build.py`` at first use) or
raises; on a CPU tensor it computes the plain version
``ref.grouped_lora_matmul_ref``.  Each call launches two kernels — the
shrink ``xa = x·A[idx]ᵀ`` into a scratch ``[M, r]`` f32 buffer that the
wrapper allocates, then the base product and the expansion — and
``launches`` counts calls (one per call), as the serve paths' checks
(banked LoRA sites a block × blocks × calls) read it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import grouped_lora_matmul_ref

#: kernel calls since the last reset (CPU calls never count)
launches = 0
#: the shrink kernel keeps x rows in shared memory as f32 (K + r bounds the
#: shapes, as it always has)
MAX_RANK = 128
MAX_SMEM_BYTES = 232_448
_DTYPES = (torch.float32, torch.bfloat16)
_FN = None


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel_fn():
    global _FN
    if _FN is None:
        from repro_torch.kernels.build import build
        fn = build("grouped_lora_matmul").grouped_lora_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _flat_idx(idx: torch.Tensor, lead: tuple) -> torch.Tensor:
    """Broadcast a per-batch index over x's leading dims, as
    ``ops.grouped_lora_matmul`` does: a [B] index against x [B, chunk, K]
    repeats over the chunk axis."""
    if idx.dim() and idx.dim() < len(lead):
        idx = idx.reshape(tuple(idx.shape) + (1,) * (len(lead) - idx.dim()))
    return idx.expand(lead).reshape(-1)


def grouped_lora_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                             a: torch.Tensor, b: torch.Tensor,
                             idx: torch.Tensor, *,
                             scale: float = 1.0) -> torch.Tensor:
    """Launch the kernels on 2-D operands: x [M, K], w [K, N], a [G, r, K],
    b [G, N, r], idx int32 [M] — all on one CUDA device and contiguous."""
    global launches
    M, K = x.shape
    N = w.shape[1]
    G, r = a.shape[0], a.shape[1]
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x/w dtypes {x.dtype}/{w.dtype}: need one of "
                        f"{_DTYPES}, equal")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a/b dtypes {a.dtype}/{b.dtype}: need one of "
                        f"{_DTYPES}, equal")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx dtype {idx.dtype}, expected int32")
    if (w.dim() != 2 or w.shape[0] != K or a.dim() != 3 or a.shape[2] != K
            or tuple(b.shape) != (G, N, r) or tuple(idx.shape) != (M,)):
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"a {tuple(a.shape)} b {tuple(b.shape)} "
                         f"idx {tuple(idx.shape)} do not agree")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside [1, {MAX_RANK}]")
    if G < 1:
        raise ValueError("empty adapter bank")
    if (K + r) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"K={K} too large for the kernel's shared memory")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} on {t.device}: the kernel needs every "
                             "operand on one CUDA device")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    xa = torch.empty((M, r), dtype=torch.float32, device=x.device)
    err = _kernel_fn()(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        idx.data_ptr(), xa.data_ptr(), y.data_ptr(), M, K, N, G, r,
        float(scale),
        int(x.dtype == torch.bfloat16), int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_lora_matmul kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return y


def grouped_lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, idx: torch.Tensor, *,
                        scale: float = 1.0) -> torch.Tensor:
    """BGMV over x [..., K]: w [K, N]; a [G, r, K]; b [G, N, r]; idx int,
    broadcastable to x's leading dims (a [B] index against x [B, chunk, K]
    covers the chunk axis).  Returns [..., N] in the dtype of x."""
    lead = tuple(x.shape[:-1])
    K = x.shape[-1]
    N = w.shape[1]
    x2 = x.reshape(-1, K)
    idx2 = _flat_idx(torch.as_tensor(idx, device=x.device), lead)
    if x.device.type == "cpu":
        y = grouped_lora_matmul_ref(x2, w, a, b, idx2, scale=scale)
    elif x.device.type == "cuda":
        y = grouped_lora_matmul_cuda(x2, w, a, b,
                                     idx2.to(torch.int32).contiguous(),
                                     scale=scale)
    else:
        raise ValueError(f"no grouped_lora_matmul for device {x.device}")
    return y.reshape(*lead, N)


__all__ = ["MAX_RANK", "grouped_lora_matmul", "grouped_lora_matmul_cuda",
           "launches", "reset_launches"]
