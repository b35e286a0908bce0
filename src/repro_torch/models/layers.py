"""Layers of every stack (port of ``repro/models/layers.py``: the training
forward and the decode paths of dense GQA attention (attn / attn_local),
gated and ungated cross-attention (vision and enc-dec), DeepSeek-V2's
multi-head latent attention (MLA), the capacity-dispatched mixture of
experts (MoE) and Mamba-2's SSD block).

Plain functions over explicit parameter dictionaries, with the reference's
conventions: weights are ``[in_dim, out_dim]`` so forward is ``x @ w``;
LoRA entries ``{"A": [r, in], "B": [out, r]}`` (or stacked banks ``[G, ...]``
with a per-row index) add ``scale * (x @ Aᵀ) @ Bᵀ``; attention has a naive
path and a chunked online-softmax path, and the per-row-position decode
paths write their caches (KV, MLA's compressed latent, Mamba's state) in
place.
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
                   device, dtype, cross: bool = False,
                   kv_in: int | None = None) -> dict:
    """Stacked (leading dim n) attention params.  ``cross``: K and V read
    ``kv_in`` features (default ``vision_dim``), and a tanh gate ``[n]``
    starts closed at 0 (llama-3.2-vision's gated cross-attention)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if kv_in is None:
        kv_in = (cfg.vision_dim or d) if cross else d
    g = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "wq": normal((n, d, h * hd), 1.0 / math.sqrt(d), **g),
        "wk": normal((n, kv_in, kv * hd), 1.0 / math.sqrt(kv_in), **g),
        "wv": normal((n, kv_in, kv * hd), 1.0 / math.sqrt(kv_in), **g),
        "wo": normal((n, h * hd, d), 1.0 / math.sqrt(h * hd), **g),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, h * hd), device=device, dtype=dtype)
        p["bk"] = torch.zeros((n, kv * hd), device=device, dtype=dtype)
        p["bv"] = torch.zeros((n, kv * hd), device=device, dtype=dtype)
    if cross:
        p["gate"] = torch.zeros((n,), device=device, dtype=dtype)
    return p


def _qkv(params, x, kv_src, cfg: ModelConfig, lora, lora_scale,
         lora_idx=None, lora_kernel: bool = False):
    """``lora_idx`` [B]: LoRA entries are stacked banks [G, ...] and row
    ``b`` applies adapter ``lora_idx[b]`` (``lora_kernel`` selects the BGMV
    kernel).  The head counts come from the weights' widths, so a rank of
    a tensor-parallel mesh computes its own heads."""
    hd = cfg.resolved_head_dim
    h, kv = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
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
                      lora_scale: float = 1.0, positions=None, pad_mask=None,
                      kv_src=None, tp=None):
    """Full-sequence attention sublayer (the caller adds the residual).
    ``kind``: "attn" (global causal), "attn_local" (sliding window) or
    "cross_attn": non-causal, no RoPE, keys and values from ``kv_src``
    [B, P, kv_in] through ``cross_kv``, ``pad_mask`` [B, P] over them, and
    the output scaled by ``tanh(gate)`` when the params carry a gate.
    ``tp`` (a ``TensorParallel`` that splits attention): ``params`` and
    ``lora`` hold this rank's heads, and ``wo``'s partial sums are added
    over the mesh."""
    if kind == "cross_attn":
        q = _q(params, x, cfg, lora, lora_scale)
        k, v = cross_kv(params, kv_src, cfg, lora, lora_scale)
        out = multihead_attention(q, k, v, causal=False, pad_mask=pad_mask)
        return _gated(params, out.reshape(x.shape[0], x.shape[1], -1)
                      @ params["wo"])
    split = tp is not None and tp.attn
    if split:
        x = tp.copy(x)
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
    y = out.reshape(B, S, -1) @ params["wo"]
    return tp.reduce(y) if split else y


def _q(params, x, cfg: ModelConfig, lora, lora_scale, lora_idx=None,
       lora_kernel: bool = False):
    """A cross sublayer's query [B, S, H, D], LoRA on ``wq`` (one adapter,
    or a bank indexed per row by ``lora_idx``)."""
    lq = lora.get("wq") if lora else None
    if lora_idx is None:
        q = lora_matmul(x, params["wq"], lq, lora_scale)
    else:
        q = grouped_lora_matmul(x, params["wq"], lq, lora_idx, lora_scale,
                                kernel=lora_kernel)
    if "bq" in params:
        q = q + params["bq"]
    return q.reshape(x.shape[0], x.shape[1], cfg.num_heads,
                     cfg.resolved_head_dim)


def cross_kv(params, src, cfg: ModelConfig, lora=None,
             lora_scale: float = 1.0):
    """A cross sublayer's keys and values [B, P, KV, D] from ``src`` [B, P,
    kv_in], with one adapter's LoRA on ``wv``.  The forward and the decode
    cache both build them here, so a cached decode reads the adapted
    values the forward reads (the reference's ``init_cache`` leaves
    ``wv``'s adapter out).  ``src`` is cast to the weights' dtype, as the
    reference's ``init_cache`` casts it (its forward lets an f32 source
    promote a bf16 stack to f32 from the first cross layer on)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    src = src.to(params["wk"].dtype)
    k = src @ params["wk"]
    v = lora_matmul(src, params["wv"], lora.get("wv") if lora else None,
                    lora_scale)
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    B = src.shape[0]
    return k.reshape(B, -1, kv, hd), v.reshape(B, -1, kv, hd)


def _gated(params, y):
    """``tanh(gate)·y`` where the sublayer has a gate (vision cross
    layers; the enc-dec decoder's cross layers have none)."""
    if "gate" in params:
        return torch.tanh(params["gate"]).to(y.dtype) * y
    return y


def attention_decode_batch(params, x, cache, cfg: ModelConfig, *, kind: str,
                           pos, valid=None, lora=None,
                           lora_scale: float = 1.0, lora_idx=None,
                           lora_kernel: bool = False,
                           chunked: bool | None = False, tp=None):
    """Multi-token, per-row-position decode — the serving hot path (one-token
    multi-adapter decode and chunked prefill share it).  ``tp``: as in
    :func:`attention_forward`; the cache then holds this rank's K/V heads.

    ``x``: [B, C, d]; ``pos``: [B] per-row first position; ``valid``:
    optional [B, C] ragged-tail mask (masked positions leave their cache
    rows untouched; their outputs are discarded by the caller).
    ``cache`` {"k","v": [B, Smax, KV, D]} is updated IN PLACE (the
    reference returns a new cache from a donated buffer); the same dict is
    returned.  Caller invariants as in the reference: valid positions stay
    below the cache length; for ring caches C ≤ ring and, when C > 1, no
    valid position reaches the ring size.

    ``kind="cross_attn"``: ``cache`` is the static ``{"k","v": [B, P, KV,
    D]}`` of ``cross_kv`` (an optional ``"mask"`` [B, P]); the C queries
    attend to all of it and nothing is written."""
    B, C = x.shape[:2]
    if kind == "cross_attn":
        q = _q(params, x, cfg, lora, lora_scale, lora_idx, lora_kernel)
        out = multihead_attention(q, cache["k"], cache["v"], causal=False,
                                  pad_mask=cache.get("mask"), chunked=False)
        return _gated(params, out.reshape(B, C, -1) @ params["wo"]), cache
    split = tp is not None and tp.attn
    if split:
        x = tp.copy(x)
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

    _write_rows(cache["k"], rows, slots, k_new, valid)
    _write_rows(cache["v"], rows, slots, v_new, valid)

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
    return (tp.reduce(y) if split else y), cache


def _write_rows(c: torch.Tensor, rows, slots, new, valid) -> None:
    """Write ``new`` [B, C, ...] into cache rows ``c[rows, slots]`` in
    place; positions where ``valid`` [B, C] is false write back the row
    they gathered — identity (clipped tails may repeat an index; their
    values agree)."""
    new = new.to(c.dtype)
    if valid is not None:
        mask = valid.reshape(tuple(valid.shape) + (1,) * (new.dim() - 2))
        new = torch.where(mask, new, c[rows, slots])
    c.index_put_((rows, slots), new)


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention (compressed KV cache)
# ---------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, *, n: int, generator: torch.Generator, device,
             dtype) -> dict:
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    nv = m.qk_nope_head_dim + m.v_head_dim
    g = dict(generator=generator, device=device, dtype=dtype)
    p = {}
    if m.q_lora_rank:
        p["wdq"] = normal((n, d, m.q_lora_rank), d ** -0.5, **g)
        p["wuq"] = normal((n, m.q_lora_rank, h * qd), m.q_lora_rank ** -0.5,
                          **g)
    else:
        p["wq"] = normal((n, d, h * qd), d ** -0.5, **g)
    p["wkv_a"] = normal((n, d, m.kv_lora_rank + m.qk_rope_head_dim),
                        d ** -0.5, **g)
    p["wkv_b"] = normal((n, m.kv_lora_rank, h * nv), m.kv_lora_rank ** -0.5,
                        **g)
    p["wo"] = normal((n, h * m.v_head_dim, d), (h * m.v_head_dim) ** -0.5, **g)
    return p


def _mla_q(params, x, cfg: ModelConfig, lora, lora_scale, lora_idx=None,
           lora_kernel: bool = False):
    """(q_nope, q_rope) [B, S, H, ·]; with ``lora_idx`` the q-side LoRA is a
    stacked bank applied per row through the grouped (BGMV) path."""
    m, h = cfg.mla, cfg.num_heads
    name = "wq" if "wq" in params else "wuq"
    src = x if name == "wq" else x @ params["wdq"]
    entry = lora.get(name) if lora else None
    if lora_idx is None:
        q = lora_matmul(src, params[name], entry, lora_scale)
    else:
        q = grouped_lora_matmul(src, params[name], entry, lora_idx,
                                lora_scale, kernel=lora_kernel)
    B, S = x.shape[:2]
    q = q.reshape(B, S, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    return q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]


def _mla_effective_wkv_b(params, lora, lora_scale):
    """``wkv_b`` with one adapter's LoRA folded in (the delta is scaled in
    the adapter's dtype, then cast to the weight's)."""
    w = params["wkv_b"]
    entry = lora.get("wkv_b") if lora else None
    if entry is not None:
        w = w + (lora_scale * torch.einsum("or,ri->io", entry["B"],
                                           entry["A"])).to(w.dtype)
    return w


def mla_forward(params, x, cfg: ModelConfig, *, lora=None,
                lora_scale: float = 1.0, positions=None, pad_mask=None):
    """Full-sequence (training / prefill) MLA with expanded K/V."""
    m, h = cfg.mla, cfg.num_heads
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_q(params, x, cfg, lora, lora_scale)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_kr = x @ params["wkv_a"]
    c_kv, k_rope = ckv_kr[..., :m.kv_lora_rank], ckv_kr[..., m.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    wkv_b = _mla_effective_wkv_b(params, lora, lora_scale)
    kv = (c_kv @ wkv_b).reshape(B, S, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    k = torch.cat([k_nope, k_rope.expand(B, S, h, m.qk_rope_head_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    out = multihead_attention(q, k, v, causal=True, q_pos=positions,
                              k_pos=positions, pad_mask=pad_mask)
    return out.reshape(B, S, -1) @ params["wo"]


def mla_decode_batch(params, x, cache, cfg: ModelConfig, *, pos, valid=None,
                     lora=None, lora_scale: float = 1.0, lora_idx=None,
                     lora_kernel: bool = False):
    """Absorbed-weight MLA decode over the compressed cache ``{"c_kv": [B,
    Smax, c], "k_rope": [B, Smax, rd]}`` at per-row positions ``pos`` [B]
    (``x`` [B, C, d]; ``valid`` [B, C] masks ragged chunk tails, whose cache
    rows stay untouched).  The up-projection folds into the query and
    context sides, so a step's work scales with ``kv_lora_rank``.  The
    cache is updated IN PLACE and returned.

    LoRA: the q side goes through the grouped (BGMV) path when ``lora_idx``
    is given; ``wkv_b``'s LoRA folds into an effective weight — per bank
    entry ([G, c, ·]) gathered per row in the banked case — so
    ``lora_kernel`` steers the q side only.  The reference's scalar-position
    ``mla_decode`` is this function with every row at one position."""
    m, h = cfg.mla, cfg.num_heads
    B, C = x.shape[:2]
    q_pos = pos[:, None] + torch.arange(C, device=pos.device)       # [B, C]
    q_nope, q_rope = _mla_q(params, x, cfg, lora, lora_scale, lora_idx,
                            lora_kernel)
    q_rope = apply_rope(q_rope, q_pos, cfg.rope_theta)
    ckv_kr = x @ params["wkv_a"]
    c_new, kr_new = ckv_kr[..., :m.kv_lora_rank], ckv_kr[..., m.kv_lora_rank:]
    kr_new = apply_rope(kr_new[:, :, None, :], q_pos, cfg.rope_theta)[:, :, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    Smax = c_kv.shape[1]
    slots = q_pos.clamp(0, Smax - 1)
    rows = torch.arange(B, device=pos.device)[:, None].expand(B, C)
    _write_rows(c_kv, rows, slots, c_new, valid)
    _write_rows(k_rope, rows, slots, kr_new, valid)

    w = params["wkv_b"]
    entry = lora.get("wkv_b") if lora else None
    if entry is not None:
        delta = torch.einsum("...or,...ri->...io", entry["B"], entry["A"])
        if lora_idx is None:
            w = w + (lora_scale * delta).to(w.dtype)                # [c, hnv]
        else:
            w = (w + lora_scale * delta.to(w.dtype))[lora_idx]     # [B, c, hnv]
    per_row = w.dim() == 3
    nv = m.qk_nope_head_dim + m.v_head_dim
    w = w.reshape((B,) * per_row + (m.kv_lora_rank, h, nv)).float()
    w_uk, w_uv = w[..., :m.qk_nope_head_dim], w[..., m.qk_nope_head_dim:]
    lead = "b" if per_row else ""
    q_abs = torch.einsum(f"bshn,{lead}chn->bshc", q_nope.float(), w_uk)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = (torch.einsum("bshc,btc->bhst", q_abs, c_kv.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(),
                        k_rope.float())) * scale                    # [B,h,C,S]
    ok = torch.arange(Smax, device=pos.device)[None, None, :] \
        <= q_pos[:, :, None]                                        # [B,C,S]
    s = torch.where(ok[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx_c = torch.einsum("bhst,btc->bshc", p, c_kv.float())
    ctx_v = torch.einsum(f"bshc,{lead}chv->bshv", ctx_c, w_uv)
    y = ctx_v.reshape(B, C, -1).to(x.dtype) @ params["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# feed-forward: dense SwiGLU and MoE (sort-based capacity dispatch)
# ---------------------------------------------------------------------------

def init_mlp(d: int, ff: int, *, n: int, generator: torch.Generator, device,
             dtype) -> dict:
    g = dict(generator=generator, device=device, dtype=dtype)
    return {
        "w1": normal((n, d, ff), 1.0 / math.sqrt(d), **g),
        "w3": normal((n, d, ff), 1.0 / math.sqrt(d), **g),
        "w2": normal((n, ff, d), 1.0 / math.sqrt(ff), **g),
    }


def mlp_forward(params, x, tp=None):
    """SwiGLU; ``tp`` (a ``TensorParallel`` that splits the MLP): ``w1`` /
    ``w3`` hold this rank's ``d_ff`` columns, ``w2`` its rows, and the
    partial sums are added over the mesh."""
    if tp is None or not tp.mlp:
        return (F.silu(x @ params["w1"]) * (x @ params["w3"])) @ params["w2"]
    x = tp.copy(x)
    return tp.reduce((F.silu(x @ params["w1"]) * (x @ params["w3"]))
                     @ params["w2"])


def init_moe(cfg: ModelConfig, *, n: int, generator: torch.Generator,
             device, dtype) -> dict:
    """Routed experts [n, E, ...] in ``dtype``, the router in f32, and the
    shared experts (one SwiGLU of width ``num_shared × d_ff_shared``)."""
    mo, d = cfg.moe, cfg.d_model
    E, ff = mo.num_experts, mo.d_ff_expert
    g = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "router": normal((n, d, E), d ** -0.5, generator, device,
                         torch.float32),
        "w1": normal((n, E, d, ff), d ** -0.5, **g),
        "w3": normal((n, E, d, ff), d ** -0.5, **g),
        "w2": normal((n, E, ff, d), ff ** -0.5, **g),
    }
    if mo.num_shared_experts:
        ffs = (mo.d_ff_shared or mo.d_ff_expert) * mo.num_shared_experts
        p["shared"] = init_mlp(d, ffs, n=n, **g)
    return p


def moe_capacity(cfg: ModelConfig, T: int) -> int:
    """Rows each expert takes from ``T`` routed tokens (the reference's
    Python float arithmetic, so both packages drop the same tokens)."""
    mo = cfg.moe
    K, E = mo.experts_per_token, mo.num_experts
    return max(int(math.ceil(K * T / E * mo.capacity_factor)), 1)


def moe_route(router: torch.Tensor, xf: torch.Tensor, cfg: ModelConfig):
    """The router's decisions for ``xf`` [T, d]: ``(probs [T, E] f32,
    gates [T, K] f32, ids [T, K], pos [T, K], kept [T, K] bool)``.

    Top-k is a stable descending sort (equal probabilities: the lower
    expert first, as ``lax.top_k``).  Dispatch is the reference's sort:
    the T·K picks ordered by expert (stable, so token order within an
    expert), ``pos`` the pick's place in its expert's queue, and a pick at
    ``pos >= moe_capacity`` is dropped.  All integers, equal to the
    reference's bit for bit."""
    mo = cfg.moe
    E, K = mo.num_experts, mo.experts_per_token
    T = xf.shape[0]
    probs = torch.softmax(xf.float() @ router, dim=-1)               # [T, E]
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :K], ids[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=xf.device))
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(T * K, device=xf.device) - starts[sorted_e]
    pos = pos.reshape(T, K)
    return probs, gates, ids, pos, pos < moe_capacity(cfg, T)


def moe_forward(params, x, cfg: ModelConfig):
    """GShard-style capacity dispatch without a [T, E, C] one-hot: picks
    are copied into ``[E, C, d]`` expert buffers, every expert runs its
    SwiGLU over its C rows, and each token gathers back its K outputs.
    Returns ``(y [B, S, d], aux)`` with the Switch load-balance loss
    ``aux``.

    The combine sums a token's K gated outputs in ascending expert order
    (the order of the reference's scatter-add) from a [T, K, d] gather, so
    no atomic adds reorder it from run to run."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = mo.num_experts, mo.experts_per_token
    C = moe_capacity(cfg, T)
    xf = x.reshape(T, d)
    probs, gates, ids, pos, kept = moe_route(params["router"], xf, cfg)
    one_hot = F.one_hot(ids[:, 0], E).float()
    aux = mo.aux_loss_coef * E * (probs.mean(0) * one_hot.mean(0)).sum()

    # dispatch: kept picks to their (expert, place) row, dropped ones to a
    # spare row that is cut off
    slot = torch.where(kept, ids * C + pos, E * C).reshape(-1)
    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = xf.repeat_interleave(K, dim=0)
    buf = buf[:E * C].reshape(E, C, d)
    h = F.silu(torch.bmm(buf, params["w1"])) * torch.bmm(buf, params["w3"])
    out = torch.bmm(h, params["w2"]).reshape(E * C, d)               # [E*C, d]

    # combine, in ascending expert order per token
    rank = ids.argsort(dim=-1)
    rows = torch.arange(T, device=x.device)[:, None]
    e_sorted, p_sorted = ids[rows, rank], pos[rows, rank]
    y_k = (out[e_sorted * C + p_sorted.clamp(max=C - 1)]
           * kept[rows, rank][..., None].to(x.dtype)
           * gates[rows, rank][..., None].to(x.dtype))               # [T,K,d]
    y = y_k[:, 0]
    for k in range(1, K):
        y = y + y_k[:, k]
    if "shared" in params:
        y = y + mlp_forward(params["shared"], xf)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Mamba-2 (SSD — state space duality, arXiv:2405.21060), chunked scan
# ---------------------------------------------------------------------------

def init_mamba(cfg: ModelConfig, *, n: int, generator: torch.Generator,
               device, dtype) -> dict:
    """Projections, conv and gate norm in ``dtype``; ``A_log``, ``D`` and
    ``dt_bias`` in f32 (the reference's init distributions)."""
    s, d = cfg.ssm, cfg.d_model
    d_in = s.expand * d
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.state_dim
    proj_out = 2 * d_in + 2 * s.state_dim + nheads     # z, xBC, dt
    g = dict(generator=generator, device=device, dtype=dtype)
    f32 = dict(device=device, dtype=torch.float32)
    u = torch.rand((n, nheads), generator=generator, **f32)
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    dt_init = torch.exp(u * (hi - lo) + lo)
    return {
        "in_proj": normal((n, d, proj_out), d ** -0.5, **g),
        "conv_w": normal((n, s.conv_width, conv_ch), s.conv_width ** -0.5,
                         **g),
        "conv_b": torch.zeros((n, conv_ch), device=device, dtype=dtype),
        "A_log": torch.log(torch.arange(1, nheads + 1, **f32)).expand(
            n, nheads).clone(),
        "D": torch.ones((n, nheads), **f32),
        "dt_bias": torch.log(torch.expm1(dt_init)),
        "gate_norm": torch.ones((n, d_in), device=device, dtype=dtype),
        "out_proj": normal((n, d_in, d), d_in ** -0.5, **g),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + eˣ)`` with no linear cut-off (``jax.nn.softplus``;
    ``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b):
    """x: [B, S, C]; w: [W, C] depthwise; left-padded causal conv in f32,
    as W shifted multiply-adds."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, W - 1, 0))
    w32 = w.float()
    out = xp[:, :S] * w32[0]
    for k in range(1, W):
        out = out + xp[:, k:k + S] * w32[k]
    return (out + b.float()).to(x.dtype)


def _segsum(x):
    """x: [..., Q] → [..., Q, Q] with out[..., i, j] = sum_{j<t<=i} x_t for
    i >= j, -inf above the diagonal.

    Each segment is summed on its own, a cumulative sum down column j of x
    masked to t > j.  The difference of two cumulative sums (the
    reference's ``cs[i] - cs[j]``) loses digits when dt·A is large: both
    sums reach hundreds while their difference is a few units."""
    Q = x.shape[-1]
    ones = torch.ones((Q, Q), dtype=torch.bool, device=x.device)
    below = x[..., :, None].expand(tuple(x.shape) + (Q,))
    seg = torch.cumsum(below.masked_fill(~torch.tril(ones, -1), 0.0), dim=-2)
    return seg.masked_fill(~torch.tril(ones), -math.inf)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Mamba-2 SSD forward, chunkwise.

    xh: [B, S, H, P]; dt: [B, S, H] (already softplus'd); A: [H]
    (negative); Bm, Cm: [B, S, N] (one group, broadcast over heads).  S is
    padded to a multiple of ``chunk``.  Returns (y [B, S, H, P] f32,
    final state [B, H, P, N] f32)."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def pad_s(t):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)).reshape(
            (Bsz, nc, chunk) + tuple(t.shape[2:]))

    xh, dt = pad_s(xh.float()), pad_s(dt.float())
    Bm, Cm = pad_s(Bm.float()), pad_s(Cm.float())

    dA = dt * A                                           # [B, nc, Q, H]
    dA_cs = torch.cumsum(dA, dim=2)
    # within a chunk (quadratic): Y = (C Bᵀ ∘ L) (dt · X)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))       # [B, nc, H, Q, Q]
    cb = torch.einsum("bcqn,bckn->bcqk", Cm, Bm)
    M = cb[:, :, None] * L
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, dt[..., None] * xh)
    # each chunk's final state, then the recurrence over chunks; the decay
    # from t to the chunk's end is L's last row (summed without cancelling)
    decay_to_end = L[:, :, :, -1, :].permute(0, 1, 3, 2)           # [B,nc,Q,H]
    states = torch.einsum("bcqn,bcqhp->bchpn", Bm,
                          (dt * decay_to_end)[..., None] * xh)     # [B,nc,H,P,N]
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                    # [B,nc,H]
    h = xh.new_zeros((Bsz, H, P, N))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                            # [B,nc,H,P,N]
    # what the state entering each chunk adds
    y_inter = (torch.einsum("bcqn,bchpn->bcqhp", Cm, h_prev)
               * torch.exp(dA_cs)[..., None])
    y = (y_intra + y_inter).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y, h


def _mamba_split(cfg: ModelConfig, t: torch.Tensor):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return torch.split(t, [d_in, d_in + 2 * s.state_dim,
                           d_in // s.head_dim], dim=-1)


def mamba_forward(params, x, cfg: ModelConfig):
    """Full-sequence Mamba-2 block: x [B, S, d] → [B, S, d]."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    z, xBC, dt = _mamba_split(cfg, x @ params["in_proj"])
    xBC = F.silu(_causal_conv(xBC, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = torch.split(xBC, [d_in, s.state_dim, s.state_dim], dim=-1)
    B_, S_ = x.shape[:2]
    xh = xs.reshape(B_, S_, H, s.head_dim)
    dt = _softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk_size)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B_, S_, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    return y @ params["out_proj"]


def mamba_decode(params, x, cache, cfg: ModelConfig, *, lora=None,
                 lora_scale: float = 1.0, lora_idx=None,
                 lora_kernel: bool = False):
    """One-token recurrent step: x [B, 1, d]; ``cache`` {"h": [B, H, P, N]
    f32, "conv": [B, W-1, C]} is updated IN PLACE and returned.

    As in the reference, ``lora`` applies only in the banked form
    (``lora_idx``, each row its own adapter through the grouped (BGMV)
    path); single-adapter callers fold the adapter into ``in_proj`` /
    ``out_proj`` upstream."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    B = x.shape[0]
    if lora_idx is not None:
        proj = grouped_lora_matmul(x, params["in_proj"],
                                   lora.get("in_proj") if lora else None,
                                   lora_idx, lora_scale,
                                   kernel=lora_kernel)[:, 0]
    else:
        proj = (x @ params["in_proj"])[:, 0]                 # [B, proj_out]
    z, xBC, dt = _mamba_split(cfg, proj)

    conv_buf = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)   # [B,W,C]
    xBC = (torch.einsum("bwc,wc->bc", conv_buf.float(),
                        params["conv_w"].float())
           + params["conv_b"].float())
    xBC = F.silu(xBC).to(x.dtype)
    cache["conv"].copy_(conv_buf[:, 1:])

    xs, Bm, Cm = torch.split(xBC, [d_in, s.state_dim, s.state_dim], dim=-1)
    xh = xs.reshape(B, H, s.head_dim).float()
    dt = _softplus(dt.float() + params["dt_bias"])                 # [B, H]
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])
    dBx = (dt[:, :, None, None] * Bm.float()[:, None, None, :]
           * xh[..., None])                                         # [B,H,P,N]
    h = dA[..., None, None] * cache["h"] + dBx
    cache["h"].copy_(h)
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, None, :]), params["gate_norm"], cfg.norm_eps)
    if lora_idx is not None:
        out = grouped_lora_matmul(y, params["out_proj"],
                                  lora.get("out_proj") if lora else None,
                                  lora_idx, lora_scale, kernel=lora_kernel)
    else:
        out = y @ params["out_proj"]
    return out, cache


__all__ = ["NEG_INF", "apply_rope", "attention_decode_batch",
           "attention_forward", "cross_kv", "init_attention", "init_mamba", "init_mla",
           "init_mlp", "init_moe", "mamba_decode", "mamba_forward",
           "mla_decode_batch", "mla_forward", "mlp_forward", "moe_capacity",
           "moe_forward", "moe_route", "multihead_attention", "normal",
           "rms_norm", "ssd_chunked"]
