"""Flash attention (forward): softmax attention with an optional causal
mask and sliding window, q [B, Sq, H, d] and k, v [B, Sk, KV, d | dv]
(grouped-query when KV < H) → [B, Sq, H, dv].

Port of ``repro.kernels.ops.flash_attention`` + the Pallas kernel
``flash_attention_pallas`` (``kernels/flash_attention.py``).  On a CUDA
tensor the wrapper launches one of two hand-written Hopper kernels (built by
``build.py`` at first use) or raises; on a CPU tensor it computes the plain
version ``ref.flash_attention_ref``.  ``flash_route`` picks the kernel from
the dtype, the shapes and whether q, k and v have 16-byte-aligned bases
(``build.aligned16``, read from ``data_ptr()`` by the wrapper):

* ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 on the tensor cores,
  fed by TMA.  TMA needs every global stride and base address to be a
  multiple of 16 bytes; the kernel's tensor maps are (width, heads, seq,
  batch), so the head widths d and dv must be multiples of 8 and q, k, v
  aligned.  The probabilities are rounded to bf16 before P·V;
* ``"tf32x3"`` (``csrc/flash_attention.cu``): f32, and bf16 whose strides
  or bases TMA refuses (such as a contiguous view at an odd element
  offset), or with no keys, on the tensor cores in 3xTF32: each f32
  operand split into two TF32 values and every product run as three
  ``mma.sync`` TF32 products with f32 sums, which keeps the f32 limit of
  1e-4 that TF32's 10 mantissa bits alone miss.  The probabilities stay
  f32 (split, not rounded to bf16).  A bf16 operand is a TF32 value with
  no small part, so in bf16 Q·Kᵀ takes one product and P·V two.

A failed launch raises; it is never retried on the other route.
``launches`` counts kernel launches on both routes, ``launches_by_route``
each route's.

Two differences from the reference's wrapper: the kernel reads query head
h's key/value head ``h // (H // KV)`` in place, where the wrapper repeated
K and V over the heads; and keys at positions ≥ Sk are always masked, where
the wrapper padded Sk to its tile and left the padded keys unmasked for
non-causal queries (the plain version never pads).  A query row with no
valid key averages every value on both routes, as the reference's oracle
does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import aligned16
from repro_torch.kernels.ref import flash_attention_ref

#: kernel launches since the last reset (CPU calls never count)
launches = 0
#: the same, per route
launches_by_route = {"wgmma": 0, "tf32x3": 0}
#: widest query/key and value head the kernels take (the repository's
#: configurations go up to 256)
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)
_FN: dict = {}


def reset_launches() -> None:
    global launches
    launches = 0
    for route in launches_by_route:
        launches_by_route[route] = 0


def flash_route(dtype: torch.dtype, B: int, Sq: int, Sk: int, H: int,
                KV: int, d: int, dv: int, aligned: bool) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bf16 whose tensor maps
    TMA takes (head widths d and dv multiples of 8, so that the head stride
    d·2 or dv·2 and every stride above it are multiples of 16 bytes, at
    least one key, and ``aligned``: the bases of q, k and v multiples of
    16 bytes), else ``"tf32x3"``."""
    del B, Sq, H, KV   # every stride above the head's is a multiple of it
    if (dtype == torch.bfloat16 and d % 8 == 0 and dv % 8 == 0 and Sk >= 1
            and aligned):
        return "wgmma"
    return "tf32x3"


def _kernel_fn(route: str):
    if route not in _FN:
        from repro_torch.kernels.build import build
        if route == "wgmma":
            fn = build("flash_attention_wgmma").flash_attention_wgmma_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p])
        else:
            fn = build("flash_attention").flash_attention_launch
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN[route] = fn
    return _FN[route]


def _check_shapes(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> tuple:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, S, heads, width], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != d or tuple(v.shape[:3]) != (B, Sk, KV)
            or KV < 1 or H % KV):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree (H must be a "
                         "multiple of KV)")
    return B, Sq, Sk, H, KV, d, v.shape[3]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Launch the kernel of ``flash_route``'s route: q [B, Sq, H, d],
    k [B, Sk, KV, d], v [B, Sk, KV, dv], all of one dtype, contiguous and
    on one CUDA device, at any base address."""
    global launches
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                        f"one of {_DTYPES}, equal")
    B, Sq, Sk, H, KV, d, dv = _check_shapes(q, k, v)
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"head widths d={d}, dv={dv} outside [1, "
                         f"{MAX_HEAD_DIM}]")
    if H > 65535 or B > 65535 or max(Sq, Sk) >= 2 ** 31:
        raise ValueError(f"q {tuple(q.shape)} too large for the kernel's "
                         "grid")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} on {t.device}: the kernel needs every "
                             "operand on one CUDA device")
    route = flash_route(q.dtype, B, Sq, Sk, H, KV, d, dv,
                        aligned16(q, k, v))
    o = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or H == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if route == "wgmma":
        err = _kernel_fn(route)(*ptrs, B, Sq, Sk, H, KV, d, dv,
                                int(bool(causal)), int(window), stream)
    else:
        err = _kernel_fn(route)(*ptrs, B, Sq, Sk, H, KV, d, dv,
                                int(bool(causal)), int(window),
                                int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed on the "
                           f"{route} route: cudaError {err}")
    launches += 1
    launches_by_route[route] += 1
    return o


def plain_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The plain version (``ref.flash_attention_ref``) in the kernel's
    layout: K and V repeated over the query heads, heads folded into the
    batch."""
    B, Sq, Sk, H, KV, d, dv = _check_shapes(q, k, v)
    rep = H // KV
    kf = k.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(B * H, Sk, d)
    vf = v.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(B * H, Sk,
                                                                  dv)
    qf = q.transpose(1, 2).reshape(B * H, Sq, d)
    out = flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    return out.reshape(B, H, Sq, dv).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention over q [B, Sq, H, d] and k, v [B, Sk, KV, d | dv] →
    [B, Sq, H, dv] in q's dtype: scale 1/sqrt(d), optional causal mask
    (query and key positions both from 0) and sliding ``window``
    (``q_pos - k_pos < window``)."""
    if q.device.type == "cpu":
        return plain_flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash_attention for device {q.device}")


__all__ = ["MAX_HEAD_DIM", "flash_attention", "flash_attention_cuda",
           "flash_route", "launches", "launches_by_route",
           "plain_flash_attention", "reset_launches"]
