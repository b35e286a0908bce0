"""Layers of the dense attention stack (port of ``repro/models/layers.py``:
the training forward and the decode paths of attn / attn_local stacks).

Plain functions over explicit parameter dictionaries, with the reference's
conventions: weights are ``[in_dim, out_dim]`` so forward is ``x @ w``;
LoRA entries ``{"A": [r, in], "B": [out, r]}`` (or stacked banks ``[G, ...]``
with a per-row index) add ``scale * (x @ Aᵀ) @ Bᵀ``; attention has a naive
path and a chunked online-softmax path, and the per-row-position decode
path writes the KV cache in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.lora import grouped_lora_matmul, lora_matmul
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def normal(shape, std: float, generator: torch.Generator, device,
           dtype) -> torch.Tensor:
    """N(0, std²) drawn in f32 from ``generator``, cast to ``dtype``."""
    t = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return t.mul_(std).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions broadcastable to x's leading+seq dims."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)                 # [D/2]
    ang = positions[..., None].float() * freqs              # [..., S, D/2]
    ang = ang[..., None, :]                                 # head axis
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(scores / cap)
    return scores


# ---------------------------------------------------------------------------
# dense attention (GQA, optional sliding window / softcap / LoRA on wq & wv)
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, *, n: int, generator: torch.Generator,
                   device, dtype) -> dict:
    """Stacked (leading dim n) self-attention params."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    g = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "wq": normal((n, d, h * hd), 1.0 / math.sqrt(d), **g),
        "wk": normal((n, d, kv * hd), 1.0 / math.sqrt(d), **g),
        "wv": normal((n, d, kv * hd), 1.0 / math.sqrt(d), **g),
        "wo": normal((n, h * hd, d), 1.0 / math.sqrt(h * hd), **g),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, h * hd), device=device, dtype=dtype)
        p["bk"] = torch.zeros((n, kv * hd), device=device, dtype=dtype)
        p["bv"] = torch.zeros((n, kv * hd), device=device, dtype=dtype)
    return p


def _qkv(params, x, kv_src, cfg: ModelConfig, lora, lora_scale,
         lora_idx=None, lora_kernel: bool = False):
    """``lora_idx`` [B]: LoRA entries are stacked banks [G, ...] and row
    ``b`` applies adapter ``lora_idx[b]`` (``lora_kernel`` selects the BGMV
    kernel)."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    lq = lora.get("wq") if lora else None
    lv = lora.get("wv") if lora else None
    if lora_idx is None:
        q = lora_matmul(x, params["wq"], lq, lora_scale)
        v = lora_matmul(kv_src, params["wv"], lv, lora_scale)
    else:
        q = grouped_lora_matmul(x, params["wq"], lq, lora_idx, lora_scale,
                                kernel=lora_kernel)
        v = grouped_lora_matmul(kv_src, params["wv"], lv, lora_idx,
                                lora_scale, kernel=lora_kernel)
    k = kv_src @ params["wk"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    B = x.shape[0]
    return (q.reshape(B, -1, h, hd), k.reshape(B, -1, kv, hd),
            v.reshape(B, -1, kv, hd))


def _attn_mask(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    """[..., Sq, Sk] additive f32 mask from position vectors."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window and window > 0:
        ok &= diff < window
    return torch.where(ok, 0.0, NEG_INF).float()


def _pad_to(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    extra = n - x.shape[dim]
    if extra == 0:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def multihead_attention(q, k, v, *, causal: bool, window: int = 0,
                        softcap: float = 0.0, q_pos=None, k_pos=None,
                        pad_mask=None, chunked: bool | None = None,
                        q_chunk: int = 512, kv_chunk: int = 1024):
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] (GQA).  Returns [B,Sq,H,Dv].

    ``chunked=None`` picks the online-softmax path when the score block
    would be large.  ``pad_mask``: [B, Sk], true = valid.  ``q_pos`` /
    ``k_pos`` may be batched ([B, Sq] / [B, Sk]): each row attends at its
    own positions; the sliding-window chunk skip is then off."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(Sq, device=dev)
    if k_pos is None:
        k_pos = torch.arange(Sk, device=dev)
    batched_pos = q_pos.dim() > 1 or k_pos.dim() > 1
    if batched_pos:
        q_pos = q_pos.expand(B, Sq)
        k_pos = k_pos.expand(B, Sk)
    scale = 1.0 / math.sqrt(D)
    if chunked is None:
        chunked = Sk > 2048 or Sq * Sk > 2048 * 2048

    qg = q.reshape(B, Sq, KV, G, D)

    if not chunked:
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
        scores = _softcap(scores, softcap)
        mask = _attn_mask(q_pos, k_pos, causal, window)  # [Sq,Sk] | [B,Sq,Sk]
        scores = scores + (mask[:, None, None] if batched_pos else mask)
        if pad_mask is not None:
            scores = scores + torch.where(pad_mask, 0.0, NEG_INF)[
                :, None, None, None, :]
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
        return out.reshape(B, Sq, H, Dv)

    # ---- chunked online-softmax path --------------------------------------
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    Sq_pad, Sk_pad = nq * q_chunk, nk * kv_chunk
    qg_p = _pad_to(qg, Sq_pad, 1).reshape(B, nq, q_chunk, KV, G, D)
    k_p = _pad_to(k, Sk_pad, 1).reshape(B, nk, kv_chunk, KV, D)
    v_p = _pad_to(v, Sk_pad, 1).reshape(B, nk, kv_chunk, KV, Dv)
    if batched_pos:
        qpos_p = _pad_to(q_pos, Sq_pad, 1).reshape(B, nq, q_chunk)
        kpos_p = (_pad_to(k_pos + 1, Sk_pad, 1) - 1).reshape(B, nk, kv_chunk)
    else:
        qpos_p = _pad_to(q_pos, Sq_pad, 0).reshape(nq, q_chunk)
        # pads → -1 (invalid)
        kpos_p = (_pad_to(k_pos + 1, Sk_pad, 0) - 1).reshape(nk, kv_chunk)
    if pad_mask is None:
        pad_mask = torch.ones((B, Sk), dtype=torch.bool, device=dev)
    pm_p = _pad_to(pad_mask.bool(), Sk_pad, 1).reshape(B, nk, kv_chunk)

    # sliding-window chunk skip: with a causal window only
    # ceil((window + q_chunk)/kv_chunk) + 1 KV chunks meet a query chunk
    window_skip = bool(causal and window and window > 0) and not batched_pos
    nk_eff = min((window + q_chunk) // kv_chunk + 2, nk) if window_skip else nk

    outs = []
    for qi in range(nq):
        qc = qg_p[:, qi].float()                   # [B, qc, KV, G, D]
        qp = qpos_p[:, qi] if batched_pos else qpos_p[qi]
        m = torch.full((B, KV, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, Dv), device=dev)
        for step in range(nk_eff):
            if window_skip:
                # last relevant chunk is the one holding qi's chunk end
                ki_raw = (qi + 1 - nk_eff + step if q_chunk == kv_chunk else
                          (qi * q_chunk + q_chunk - 1) // kv_chunk + 1
                          - nk_eff + step)
                in_range = 0 <= ki_raw < nk
                ki = min(max(ki_raw, 0), nk - 1)
            else:
                ki, in_range = step, True
            kc, vc = k_p[:, ki], v_p[:, ki]
            kp = kpos_p[:, ki] if batched_pos else kpos_p[ki]
            s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc.float()) * scale
            s = _softcap(s, softcap)
            mask = _attn_mask(qp, kp, causal, window)
            if batched_pos:
                mask = torch.where((kp >= 0)[:, None, :], mask, NEG_INF)
                s = s + mask[:, None, None]
            else:
                mask = torch.where((kp >= 0)[None, :], mask, NEG_INF)
                s = s + mask
            s = s + torch.where(pm_p[:, ki], 0.0, NEG_INF)[:, None, None, None, :]
            if not in_range:                      # clamped duplicate chunk
                s = torch.full_like(s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vc.float())
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]             # [B,KV,G,qc,Dv]
        outs.append(out.permute(0, 3, 1, 2, 4))               # [B,qc,KV,G,Dv]
    out = torch.stack(outs, 1).reshape(B, Sq_pad, H, Dv)[:, :Sq]
    return out.to(v.dtype)


def attention_forward(params, x, cfg: ModelConfig, *, kind: str, lora=None,
                      lora_scale: float = 1.0, positions=None, pad_mask=None):
    """Full-sequence self-attention sublayer (the caller adds the residual).
    ``kind``: "attn" (global causal) or "attn_local" (sliding window)."""
    if kind not in ("attn", "attn_local"):
        raise NotImplementedError(f"attention_forward covers attn and "
                                  f"attn_local, not {kind!r}")
    q, k, v = _qkv(params, x, x, cfg, lora, lora_scale)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if kind == "attn_local" else 0
    out = multihead_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_logit_softcap,
                              q_pos=positions, k_pos=positions,
                              pad_mask=pad_mask)
    return out.reshape(B, S, -1) @ params["wo"]


def attention_decode_batch(params, x, cache, cfg: ModelConfig, *, kind: str,
                           pos, valid=None, lora=None,
                           lora_scale: float = 1.0, lora_idx=None,
                           lora_kernel: bool = False,
                           chunked: bool | None = False):
    """Multi-token, per-row-position decode — the serving hot path (one-token
    multi-adapter decode and chunked prefill share it).

    ``x``: [B, C, d]; ``pos``: [B] per-row first position; ``valid``:
    optional [B, C] ragged-tail mask (masked positions leave their cache
    rows untouched; their outputs are discarded by the caller).
    ``cache`` {"k","v": [B, Smax, KV, D]} is updated IN PLACE (the
    reference returns a new cache from a donated buffer); the same dict is
    returned.  Caller invariants as in the reference: valid positions stay
    below the cache length; for ring caches C ≤ ring and, when C > 1, no
    valid position reaches the ring size."""
    if kind == "cross_attn":
        raise NotImplementedError("batched decode covers self-attention "
                                  "caches only")
    B, C = x.shape[:2]
    q, k_new, v_new = _qkv(params, x, x, cfg, lora, lora_scale,
                           lora_idx=lora_idx, lora_kernel=lora_kernel)
    q_pos = pos[:, None] + torch.arange(C, device=pos.device)    # [B, C]
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k_new = apply_rope(k_new, q_pos, cfg.rope_theta)
    Smax = cache["k"].shape[1]
    ring = bool(kind == "attn_local" and cfg.sliding_window
                and Smax <= cfg.sliding_window)
    slots = torch.remainder(q_pos, Smax) if ring else q_pos.clamp(0, Smax - 1)
    rows = torch.arange(B, device=pos.device)[:, None].expand(B, C)

    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        new = new.to(c.dtype)
        if valid is not None:
            # masked positions write back the row they gathered — identity
            # (clipped tails may repeat an index; their values agree)
            new = torch.where(valid[..., None, None], new, c[rows, slots])
        c.index_put_((rows, slots), new)

    n_val = valid.sum(1) if valid is not None else torch.full_like(pos, C)
    cur = pos + n_val - 1                # last position actually written
    if ring:
        # ring slot t holds the latest written position ≡ t (mod Smax);
        # anchoring on cur keeps masked tails advertising the old positions
        t = torch.arange(Smax, device=pos.device)[None, :]
        k_pos = cur[:, None] - torch.remainder(cur[:, None] - t, Smax)
    else:
        k_pos = torch.arange(Smax, device=pos.device).expand(B, Smax)
    window = cfg.sliding_window if kind == "attn_local" else 0
    ok = (k_pos >= 0) & (k_pos <= cur[:, None])
    out = multihead_attention(q, cache["k"], cache["v"], causal=True,
                              window=window, softcap=cfg.attn_logit_softcap,
                              q_pos=q_pos, k_pos=k_pos, pad_mask=ok,
                              chunked=chunked, q_chunk=max(C, 1),
                              kv_chunk=min(512, Smax))
    y = out.reshape(B, C, -1) @ params["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# feed-forward: dense SwiGLU
# ---------------------------------------------------------------------------

def init_mlp(d: int, ff: int, *, n: int, generator: torch.Generator, device,
             dtype) -> dict:
    g = dict(generator=generator, device=device, dtype=dtype)
    return {
        "w1": normal((n, d, ff), 1.0 / math.sqrt(d), **g),
        "w3": normal((n, d, ff), 1.0 / math.sqrt(d), **g),
        "w2": normal((n, ff, d), 1.0 / math.sqrt(ff), **g),
    }


def mlp_forward(params, x):
    return (F.silu(x @ params["w1"]) * (x @ params["w3"])) @ params["w2"]


__all__ = ["NEG_INF", "apply_rope", "attention_decode_batch",
           "attention_forward",
           "init_attention", "init_mlp", "mlp_forward", "multihead_attention",
           "normal", "rms_norm"]
