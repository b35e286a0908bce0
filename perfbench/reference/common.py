"""Plain building blocks of the references: the matrix product in a stated
precision, RMS norm, rotary embedding, causal attention and SwiGLU.

``Precision`` decides how every linear layer multiplies.  ``"config"``
computes as the configuration states (bf16 operands, f32 accumulation,
for a bf16 model); ``"f32"`` upcasts the operands to f32 (TF32 off);
``"fp8"`` is the control a step below bf16: both operands of each product
are rounded to float8 e4m3 with a per-tensor scale (amax to 448), then
multiplied, with the gradient passing the rounding unchanged.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / x.detach().abs().amax().float().clamp_min(1e-12)
    q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


class Precision:
    def __init__(self, mode: str, act_dtype: torch.dtype):
        if mode not in ("config", "f32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.act = torch.float32 if mode == "f32" else act_dtype

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` in this precision; the result in the activations'
        dtype."""
        if self.mode == "f32":
            return x.float() @ w.float()
        if self.mode == "fp8":
            return _fp8(x.to(self.act)) @ _fp8(w.to(self.act))
        return x.to(self.act) @ w.to(self.act)

    def lora(self, x, w, a, b, scale: float) -> torch.Tensor:
        """``x @ w + scale · (x Aᵀ) Bᵀ``: the adapter's product in f32 (its
        leaves' type), added in the activations' dtype."""
        y = self.mm(x, w)
        if a is None:
            return y
        xa = x.float() @ a.float().transpose(-1, -2)
        if self.mode == "fp8":
            xa = _fp8(xa)
        return y + (scale * (xa @ b.float().transpose(-1, -2))).to(y.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
            * w.float()).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` [B, S, H, D] at positions ``pos`` [S]: the
    first and second halves of each head rotate as pairs, frequencies
    ``theta^(-2i/D)``."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device,
                                  dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def causal_attention(q, k, v) -> torch.Tensor:
    """Softmax attention, causal, grouped heads: q [B, S, H, D], k / v
    [B, S, KV, D] -> [B, S, H, D].  Scores and softmax in f32; the
    probabilities meet ``v`` in its dtype."""
    B, S, H, D = q.shape
    kv = k.shape[2]
    if kv != H:
        k = k.repeat_interleave(H // kv, dim=2)
        v = v.repeat_interleave(H // kv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def swiglu(prec: Precision, x, w1, w3, w2) -> torch.Tensor:
    h = torch.nn.functional.silu(prec.mm(x, w1)) * prec.mm(x, w3)
    return prec.mm(h, w2)
