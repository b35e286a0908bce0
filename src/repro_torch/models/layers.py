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
                        q_chunk: int = 512, kv_chunk: int = 1024,
                        return_lse: bool = False):
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] (GQA).  Returns [B,Sq,H,Dv]; with
    ``return_lse`` (the naive path only) also the scores' log-sum-exp
    ``[B, Sq, H]`` f32, for combining attention over split keys.

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
        if return_lse:
            lse = torch.logsumexp(scores, dim=-1)            # [B,KV,G,Sq]
            return out.reshape(B, Sq, H, Dv), \
                lse.permute(0, 3, 1, 2).reshape(B, Sq, H)
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
    ``lora`` hold this rank's heads (a cross layer's K / V its KV heads of
    ``kv_src``, which the caller passes through ``tp.copy`` once for all
    layers where it takes a gradient), and ``wo``'s partial sums are added
    over the mesh before the gate."""
    split = tp is not None and tp.attn
    if split:
        x = tp.copy(x)
    if kind == "cross_attn":
        q = _q(params, x, cfg, lora, lora_scale)
        k, v = cross_kv(params, kv_src, cfg, lora, lora_scale)
        out = multihead_attention(q, k, v, causal=False, pad_mask=pad_mask)
        y = out.reshape(x.shape[0], x.shape[1], -1) @ params["wo"]
        return _gated(params, tp.reduce(y) if split else y)
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
    hd = cfg.resolved_head_dim
    return q.reshape(x.shape[0], x.shape[1], -1, hd)


def cross_kv(params, src, cfg: ModelConfig, lora=None,
             lora_scale: float = 1.0):
    """A cross sublayer's keys and values [B, P, KV, D] from ``src`` [B, P,
    kv_in], with one adapter's LoRA on ``wv``.  The forward and the decode
    cache both build them here, so a cached decode reads the adapted
    values the forward reads (the reference's ``init_cache`` leaves
    ``wv``'s adapter out).  ``src`` is cast to the weights' dtype, as the
    reference's ``init_cache`` casts it (its forward lets an f32 source
    promote a bf16 stack to f32 from the first cross layer on).  The KV
    heads are the weights' (a tensor-parallel rank's own)."""
    hd = cfg.resolved_head_dim
    src = src.to(params["wk"].dtype)
    k = src @ params["wk"]
    v = lora_matmul(src, params["wv"], lora.get("wv") if lora else None,
                    lora_scale)
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    B, P = src.shape[:2]
    return k.reshape(B, P, -1, hd), v.reshape(B, P, -1, hd)


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
                           chunked: bool | None = False, tp=None,
                           cache_axis=None):
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

    ``cache_axis`` (a mesh axis of ``tp``'s mesh): the cache holds this
    rank's block of ``Smax / m`` positions (ring slots, for a local
    layer's ring) of the axis' ``m`` — on ``"model"`` (the ``seq``
    placement) with every K/V head, on ``"data"`` (the long-context
    fallback) with the rank's heads, one position a row a call (``C =
    1``).  The new token's q / k / v are then gathered over the heads
    (``"model"``), the rank that owns a position writes it, each rank attends over its positions, and the partial
    outputs are combined over the axis (:meth:`TensorParallel.combine`)
    before the rank's heads enter ``wo``.

    ``kind="cross_attn"``: ``cache`` is the static ``{"k","v": [B, P, KV,
    D]}`` of ``cross_kv`` (an optional ``"mask"`` [B, P]); the C queries
    attend to all of it and nothing is written."""
    B, C = x.shape[:2]
    split = tp is not None and tp.attn
    if split:
        x = tp.copy(x)
    if kind == "cross_attn":
        q = _q(params, x, cfg, lora, lora_scale, lora_idx, lora_kernel)
        out = multihead_attention(q, cache["k"], cache["v"], causal=False,
                                  pad_mask=cache.get("mask"), chunked=False)
        y = out.reshape(B, C, -1) @ params["wo"]
        return _gated(params, tp.reduce(y) if split else y), cache
    q, k_new, v_new = _qkv(params, x, x, cfg, lora, lora_scale,
                           lora_idx=lora_idx, lora_kernel=lora_kernel)
    q_pos = pos[:, None] + torch.arange(C, device=pos.device)    # [B, C]
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k_new = apply_rope(k_new, q_pos, cfg.rope_theta)
    heads = split and cache_axis == "model"
    if heads:                     # the seq cache holds every head
        q, k_new, v_new = (tp.all_heads(q), tp.all_heads(k_new, kv=True),
                           tp.all_heads(v_new, kv=True))
    if cache_axis is not None and C != 1:
        raise ValueError("a sequence-split cache takes one position a row "
                         f"a call (C = 1), got C = {C}")
    m, c = (1, 0) if cache_axis is None else (tp.mesh.shape[cache_axis],
                                              tp.mesh.coord(cache_axis))
    S_loc = cache["k"].shape[1]
    Smax = S_loc * m                                    # the whole length
    ring = bool(kind == "attn_local" and cfg.sliding_window
                and Smax <= cfg.sliding_window)
    slots = torch.remainder(q_pos, Smax) if ring else q_pos.clamp(0, Smax - 1)
    rows = torch.arange(B, device=pos.device)[:, None].expand(B, C)
    own = valid
    if cache_axis is not None:    # the rank holding a slot writes it
        mine = (slots >= c * S_loc) & (slots < (c + 1) * S_loc)
        own = mine if valid is None else valid & mine
        slots = (slots - c * S_loc).clamp(0, S_loc - 1)

    _write_rows(cache["k"], rows, slots, k_new, own)
    _write_rows(cache["v"], rows, slots, v_new, own)

    n_val = valid.sum(1) if valid is not None else torch.full_like(pos, C)
    cur = pos + n_val - 1                # last position actually written
    t = c * S_loc + torch.arange(S_loc, device=pos.device)[None, :]
    if ring:
        # ring slot t holds the latest written position ≡ t (mod Smax);
        # anchoring on cur keeps masked tails advertising the old positions
        k_pos = cur[:, None] - torch.remainder(cur[:, None] - t, Smax)
    else:
        k_pos = t.expand(B, S_loc)
    window = cfg.sliding_window if kind == "attn_local" else 0
    ok = (k_pos >= 0) & (k_pos <= cur[:, None])
    if cache_axis is None:
        out = multihead_attention(q, cache["k"], cache["v"], causal=True,
                                  window=window,
                                  softcap=cfg.attn_logit_softcap,
                                  q_pos=q_pos, k_pos=k_pos, pad_mask=ok,
                                  chunked=chunked, q_chunk=max(C, 1),
                                  kv_chunk=min(512, Smax))
    else:
        out, lse = multihead_attention(
            q, cache["k"], cache["v"], causal=True, window=window,
            softcap=cfg.attn_logit_softcap, q_pos=q_pos, k_pos=k_pos,
            pad_mask=ok, chunked=False, return_lse=True)
        out = tp.combine(out, lse, cache_axis)
        if heads:
            out = tp.own_heads(out)
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
    """(q_nope, q_rope) [B, S, H, ·] (H: the weights' heads, a
    tensor-parallel rank's own); with ``lora_idx`` the q-side LoRA is a
    stacked bank applied per row through the grouped (BGMV) path."""
    m = cfg.mla
    name = "wq" if "wq" in params else "wuq"
    src = x if name == "wq" else x @ params["wdq"]
    entry = lora.get(name) if lora else None
    if lora_idx is None:
        q = lora_matmul(src, params[name], entry, lora_scale)
    else:
        q = grouped_lora_matmul(src, params[name], entry, lora_idx,
                                lora_scale, kernel=lora_kernel)
    B, S = x.shape[:2]
    q = q.reshape(B, S, -1, m.qk_nope_head_dim + m.qk_rope_head_dim)
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


def _mla_heads(params, cfg: ModelConfig) -> int:
    """The heads of these weights (a tensor-parallel rank's own)."""
    m = cfg.mla
    return params["wkv_b"].shape[-1] // (m.qk_nope_head_dim + m.v_head_dim)


def mla_forward(params, x, cfg: ModelConfig, *, lora=None,
                lora_scale: float = 1.0, positions=None, pad_mask=None,
                tp=None):
    """Full-sequence (training / prefill) MLA with expanded K/V.  ``tp``
    (a ``TensorParallel`` that splits MLA): ``wuq`` / ``wq``, ``wkv_b``
    and their adapters hold this rank's heads, ``wo`` its rows, and
    ``wo``'s partial sums are added over the mesh; the compressed
    latents are whole on every rank."""
    m, h = cfg.mla, _mla_heads(params, cfg)
    split = tp is not None and tp.mla
    if split:
        x = tp.copy(x)
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
    y = out.reshape(B, S, -1) @ params["wo"]
    return tp.reduce(y) if split else y


def mla_decode_batch(params, x, cache, cfg: ModelConfig, *, pos, valid=None,
                     lora=None, lora_scale: float = 1.0, lora_idx=None,
                     lora_kernel: bool = False, tp=None, cache_axis=None,
                     score_axis=None):
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
    ``mla_decode`` is this function with every row at one position.
    ``tp``: as in :func:`mla_forward` (the absorbed ``w_uk`` / ``w_uv``
    are this rank's heads; the cache is whole).

    ``cache_axis``: the cache holds this rank's ``Smax / m`` positions of
    the axis (the ``seq`` placement on ``"model"``, the long-context
    fallback on ``"data"``); ``score_axis`` (the reference's ``seq_axis``,
    the ``scoreshard`` placement): the cache is whole and each rank scores
    its ``Smax / m`` positions of it.  Either way the absorbed queries are
    gathered over the heads (``"model"``), each rank's softmax over its
    positions is combined over the axis (:meth:`TensorParallel.combine`,
    on ``ctx_c`` ``[B, C, h, c]``), and each rank applies its heads'
    ``w_uv``."""
    m, h = cfg.mla, _mla_heads(params, cfg)
    split = tp is not None and tp.mla
    if split:
        x = tp.copy(x)
    B, C = x.shape[:2]
    q_pos = pos[:, None] + torch.arange(C, device=pos.device)       # [B, C]
    q_nope, q_rope = _mla_q(params, x, cfg, lora, lora_scale, lora_idx,
                            lora_kernel)
    q_rope = apply_rope(q_rope, q_pos, cfg.rope_theta)
    ckv_kr = x @ params["wkv_a"]
    c_new, kr_new = ckv_kr[..., :m.kv_lora_rank], ckv_kr[..., m.kv_lora_rank:]
    kr_new = apply_rope(kr_new[:, :, None, :], q_pos, cfg.rope_theta)[:, :, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    if cache_axis is not None:    # the cache's split already splits scores
        score_axis = None
        if C != 1:
            raise ValueError("a sequence-split cache takes one position a "
                             f"row a call (C = 1), got C = {C}")
    axis = cache_axis or score_axis
    n_ax, co = (1, 0) if axis is None else (tp.mesh.shape[axis],
                                            tp.mesh.coord(axis))
    S_loc = c_kv.shape[1]
    Smax = S_loc * n_ax if cache_axis is not None else S_loc
    slots = q_pos.clamp(0, Smax - 1)
    rows = torch.arange(B, device=pos.device)[:, None].expand(B, C)
    own = valid
    if cache_axis is not None:    # the rank holding a position writes it
        mine = (slots >= co * S_loc) & (slots < (co + 1) * S_loc)
        own = mine if valid is None else valid & mine
        slots = (slots - co * S_loc).clamp(0, S_loc - 1)
    _write_rows(c_kv, rows, slots, c_new, own)
    _write_rows(k_rope, rows, slots, kr_new, own)

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
    q_rope = q_rope.float()
    heads = split and axis == "model"
    if heads:                     # every head scores this rank's positions
        q_abs, q_rope = tp.all_heads(q_abs), tp.all_heads(q_rope)
    t0 = 0
    if score_axis is not None:    # this rank's positions of a whole cache
        S_loc = Smax // n_ax
        t0 = co * S_loc
        c_kv, k_rope = c_kv.narrow(1, t0, S_loc), k_rope.narrow(1, t0, S_loc)
    elif cache_axis is not None:
        t0 = co * S_loc
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = (torch.einsum("bshc,btc->bhst", q_abs, c_kv.float())
         + torch.einsum("bshr,btr->bhst", q_rope,
                        k_rope.float())) * scale                    # [B,h,C,S]
    ok = t0 + torch.arange(S_loc, device=pos.device)[None, None, :] \
        <= q_pos[:, :, None]                                        # [B,C,S]
    s = torch.where(ok[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx_c = torch.einsum("bhst,btc->bshc", p, c_kv.float())
    if axis is not None:
        lse = torch.logsumexp(s, dim=-1).permute(0, 2, 1)           # [B,C,h]
        ctx_c = tp.combine(ctx_c, lse, axis)
        if heads:
            ctx_c = tp.own_heads(ctx_c)
    ctx_v = torch.einsum(f"bshc,{lead}chv->bshv", ctx_c, w_uv)
    y = ctx_v.reshape(B, C, -1).to(x.dtype) @ params["wo"]
    return (tp.reduce(y) if split else y), cache


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
        return _swiglu(params, x)
    return tp.reduce(_swiglu(params, tp.copy(x)))


def _swiglu(params, x):
    return (F.silu(x @ params["w1"]) * (x @ params["w3"])) @ params["w2"]


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


def moe_places(ids: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
               tp=None):
    """The routed picks' places over the global batch: ``(places [T, K],
    kept [T, K], C, counts)``.  Without a batch-sharded ``tp`` (``tp.dp``
    of 1) the places are ``pos``, ``C`` is ``moe_capacity(T)`` and
    ``counts`` is ``None``.  Otherwise this rank's ``T`` tokens are its
    block of the global ``T · dp`` (in batch-coordinate order): one
    all-gather of each rank's picks per expert (``counts`` ``[dp, E]``)
    offsets a pick's place by its expert's picks on the ranks before this
    one, ``C`` is ``moe_capacity(T · dp)``, and the drops are the
    reference's on the whole batch."""
    T = ids.shape[0]
    if tp is None or tp.dp == 1:
        C = moe_capacity(cfg, T)
        return pos, pos < C, C, None
    E = cfg.moe.num_experts
    flat = ids.reshape(-1)
    cnt = torch.zeros(E, dtype=flat.dtype, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    counts = tp.mesh.all_gather(cnt[None], tp.batch_axes)           # [dp, E]
    off = counts[:tp.mesh.coord(tp.batch_axes)].sum(0)
    places = pos + off[ids]
    C = moe_capacity(cfg, T * tp.dp)
    return places, places < C, C, counts


def _experts(params, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its rows: ``buf [E, R, d]`` -> ``[E, R,
    d]``."""
    h = F.silu(torch.bmm(buf, params["w1"])) * torch.bmm(buf, params["w3"])
    return torch.bmm(h, params["w2"])


def _moe_tiles(params, xf: torch.Tensor, ids, pos, kept):
    """The experts over this rank's kept picks alone, for a batch-sharded
    step: under the global capacity a rank may keep up to ``min(C, T)``
    picks of one expert, but all its experts together keep at most ``T·K``.
    The kept picks lie in expert order in tiles of ``Q = ceil(T·K / 4E)``
    rows, each tile one expert's, in at most ``min(5E, T·K)`` tiles
    (``Σ ceil(n_e / Q) <= T·K / Q + E``), and every tile runs its expert's
    SwiGLU in one ``bmm`` over the tiles' gathered weights: at most 1.25
    ``T·K`` rows, where ``[E, min(C, T)]`` buffers hold up to ``dp``
    times the rank's share.  Returns ``(out [rows, d], row [T, K])``, a
    pick's row of ``out`` (a dropped pick's: row 0)."""
    T, d = xf.shape
    E, K = params["w1"].shape[0], ids.shape[1]
    Q = max(-(-T * K // (4 * E)), 1)
    n = min(5 * E, T * K)                                   # tiles
    flat = ids.reshape(-1)
    n_e = torch.zeros(E, dtype=flat.dtype, device=flat.device).scatter_add_(
        0, flat, kept.reshape(-1).to(flat.dtype))
    tiles = (n_e + Q - 1) // Q
    ends = tiles.cumsum(0)
    row = torch.where(kept, (ends - tiles)[ids] * Q + pos, n * Q)
    buf = xf.new_zeros((n * Q + 1, d))
    buf[row.reshape(-1)] = xf.repeat_interleave(K, dim=0)
    owner = torch.searchsorted(ends, torch.arange(n, device=xf.device),
                               right=True).clamp(max=E - 1)
    w = {k: params[k][owner] for k in ("w1", "w3", "w2")}
    out = _experts(w, buf[:n * Q].reshape(n, Q, d)).reshape(n * Q, d)
    return out, torch.where(kept, row, 0)


def _moe_exchange(params, send: torch.Tensor, counts, C: int, tp):
    """Expert-parallel experts: ``send [E, R, d]`` holds this rank's kept
    picks of each expert at their places in its own queue (row ``i`` of
    expert ``e``: its ``i``-th pick of ``e``).  The rows of the ``E /
    data`` experts each ``"data"`` rank holds go to it in one all-to-all;
    the owner lays every source's rows at their global places (the
    source's offset, from ``counts``, plus ``i``) into the reference's
    ``[E / data, C, d]`` buffer, runs its experts once over it, and sends
    each source's rows back the same way.  Fixed shapes: every source
    sends its ``R = min(C, T)`` rows an expert, the most it can keep (an
    all-to-all that sends its counts first would move only the kept
    rows).  ``counts`` ``None`` (the batch not split over ``"data"``):
    every source sends the same ``C`` rows an expert, and the owner runs
    source 0's and returns those results to every source.  Returns
    ``[E, R, d]`` in ``send``'s layout."""
    mesh = tp.mesh
    E, R, d = send.shape
    De = mesh.shape["data"]
    El, cd = E // De, mesh.coord("data")
    recv = mesh.exchange(send.reshape(De, El * R, d), "data")  # [src, El*R, d]
    i = torch.arange(R, device=send.device)[None, None, :]
    experts = torch.arange(El, device=send.device)[None, :, None]
    if counts is None:
        # the batch is not split over "data": every source holds the same
        # picks (R = C rows, place = i), so the owner lays out source 0's
        # and sends every source the rows of that one layout
        row = i.expand(De, El, R)
        dst = torch.where(row < C, experts * C + row, El * C).reshape(-1)
        put = torch.where(torch.arange(De * El * R, device=send.device)
                          < El * R, dst, El * C)
    else:
        base = mesh.coord(tp.batch_axes) - cd       # this pod's first source
        starts = counts.cumsum(0) - counts                     # [dp, E]
        mine = slice(cd * El, (cd + 1) * El)
        src = slice(base, base + De)
        row = starts[src, mine][:, :, None] + i                # [De, El, R]
        ok = (i < counts[src, mine][:, :, None]) & (row < C)
        dst = put = torch.where(ok, experts * C + row, El * C).reshape(-1)
    buf = send.new_zeros((El * C + 1, d))
    buf[put] = recv.reshape(-1, d)
    out = _experts(params, buf[:El * C].reshape(El, C, d)).reshape(El * C, d)
    out = torch.cat([out, out.new_zeros((1, d))])
    back = mesh.exchange(out[dst].reshape(De, El * R, d), "data")
    return back.reshape(E, R, d)


def moe_forward(params, x, cfg: ModelConfig, tp=None, reduce: bool = True):
    """GShard-style capacity dispatch without a [T, E, C] one-hot: picks
    are copied into expert buffers, every expert runs its SwiGLU over its
    rows, and each token gathers back its K outputs.
    Returns ``(y [B, S, d], aux)`` with the Switch load-balance loss
    ``aux``.

    The combine sums a token's K gated outputs in ascending expert order
    (the order of the reference's scatter-add) from a [T, K, d] gather, so
    no atomic adds reorder it from run to run.

    ``tp`` (a ``TensorParallel`` that splits MoE): the experts' ``w1`` /
    ``w3`` and the shared expert's hold this rank's ``d_ff`` columns,
    ``w2`` its rows.  The router runs whole on every rank, so every rank
    routes, places and drops alike; each rank combines its partial
    outputs in the same order, and the routed and shared partial sums
    pass one all-reduce (``reduce=False`` leaves them partial, for a
    sequence-parallel caller that reduce-scatters them).  ``aux`` is the
    same on every rank.

    A batch-sharded ``tp`` (``tp.batched``): capacity, places and drops
    are those of the global batch (:func:`moe_places`), and ``aux``'s
    means span it (all-reduces over the batch axes; its gradient reaches
    each rank's own tokens).  Each rank's buffer holds its own picks at
    their places in its own queue: compacted into tiles of one expert
    each (:func:`_moe_tiles`), or under ``tp.ep`` ``R = min(C, T)`` rows an
    expert, the buffers sent to the experts' owners and back
    (:func:`_moe_exchange`).  Unsharded, the buffers are ``[E, C, d]``."""
    mo = cfg.moe
    split = tp is not None and tp.moe
    B, S, d = x.shape
    T = B * S
    E, K = mo.num_experts, mo.experts_per_token
    xf = x.reshape(T, d)
    probs, gates, ids, pos, _ = moe_route(params["router"], xf, cfg)
    _, kept, C, counts = moe_places(ids, pos, cfg, tp)
    one_hot = F.one_hot(ids[:, 0], E).float()
    if counts is None:
        aux = mo.aux_loss_coef * E * (probs.mean(0) * one_hot.mean(0)).sum()
    else:
        n = T * tp.dp
        me = tp.mesh.reduce_from(probs.sum(0), tp.batch_axes) / n
        ce = tp.mesh.all_reduce(one_hot.sum(0), tp.batch_axes) / n
        aux = mo.aux_loss_coef * E * (me * ce).sum()

    if split:
        # the experts' inputs and the gates meet this rank's columns: both
        # take the ranks' partial gradients
        xf, gates = tp.copy(xf), tp.copy(gates)
    if counts is not None and not (tp is not None and tp.ep):
        out, row = _moe_tiles(params, xf, ids, pos, kept)
    else:
        # dispatch: kept picks to their (expert, place) row, dropped ones to
        # a spare row that is cut off
        R = C if counts is None else min(C, T)
        slot = torch.where(kept, ids * R + pos, E * R).reshape(-1)
        buf = x.new_zeros((E * R + 1, d))
        buf[slot] = xf.repeat_interleave(K, dim=0)
        buf = buf[:E * R].reshape(E, R, d)
        if tp is not None and tp.ep:
            out = _moe_exchange(params, buf, counts, C, tp).reshape(E * R, d)
        else:
            out = _experts(params, buf).reshape(E * R, d)           # [E*R, d]
        row = ids * R + pos.clamp(max=R - 1)

    # combine, in ascending expert order per token
    rank = ids.argsort(dim=-1)
    rows = torch.arange(T, device=x.device)[:, None]
    y_k = (out[row[rows, rank]]
           * kept[rows, rank][..., None].to(x.dtype)
           * gates[rows, rank][..., None].to(x.dtype))               # [T,K,d]
    y = y_k[:, 0]
    for k in range(1, K):
        y = y + y_k[:, k]
    if "shared" in params:
        y = y + _swiglu(params["shared"], xf)
    y = y.reshape(B, S, d)
    return (tp.reduce(y) if split and reduce else y), aux


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


def _mamba_heads(params, cfg: ModelConfig) -> tuple[int, int]:
    """(SSM heads, d_in) of these weights (a tensor-parallel rank's)."""
    H = params["A_log"].shape[-1]
    return H, H * cfg.ssm.head_dim


def _mamba_split(cfg: ModelConfig, t: torch.Tensor, H: int):
    d_in = H * cfg.ssm.head_dim
    return torch.split(t, [d_in, d_in + 2 * cfg.ssm.state_dim, H], dim=-1)


def _gate_norm(y, scale, cfg: ModelConfig, tp=None):
    """The gated RMS norm over ``d_in``.  ``tp``: ``y`` holds this rank's
    heads; the mean square is each rank's mean times its share of
    ``d_in``, summed over the mesh (the share is exactly 1 on one rank,
    where this is ``rms_norm``)."""
    if tp is None:
        return rms_norm(y, scale, cfg.norm_eps)
    y32 = y.float()
    share = y.shape[-1] / (cfg.ssm.expand * cfg.d_model)
    var = tp.sum(y32.square().mean(-1, keepdim=True) * share)
    return (y32 * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(y.dtype)


def mamba_forward(params, x, cfg: ModelConfig, tp=None):
    """Full-sequence Mamba-2 block: x [B, S, d] → [B, S, d].  ``tp`` (a
    ``TensorParallel`` that splits Mamba): the weights are this rank's
    pieces — ``in_proj``'s ``z`` / ``xs`` / ``dt`` columns and the conv's
    ``xs`` channels of its heads beside the whole ``B`` / ``C``, its
    heads' ``A_log`` / ``D`` / ``dt_bias`` / ``gate_norm`` and
    ``out_proj``'s rows — and the heads' scan needs no collective."""
    s = cfg.ssm
    H, d_in = _mamba_heads(params, cfg)
    split = tp is not None and tp.mamba
    if split:
        x = tp.copy(x)
    z, xBC, dt = _mamba_split(cfg, x @ params["in_proj"], H)
    xBC = F.silu(_causal_conv(xBC, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = torch.split(xBC, [d_in, s.state_dim, s.state_dim], dim=-1)
    B_, S_ = x.shape[:2]
    xh = xs.reshape(B_, S_, H, s.head_dim)
    dt = _softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk_size)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B_, S_, d_in).to(x.dtype)
    y = _gate_norm(y * F.silu(z), params["gate_norm"], cfg,
                   tp if split else None)
    out = y @ params["out_proj"]
    return tp.reduce(out) if split else out


def mamba_decode(params, x, cache, cfg: ModelConfig, *, lora=None,
                 lora_scale: float = 1.0, lora_idx=None,
                 lora_kernel: bool = False, tp=None):
    """One-token recurrent step: x [B, 1, d]; ``cache`` {"h": [B, H, P, N]
    f32, "conv": [B, W-1, C]} is updated IN PLACE and returned.

    As in the reference, ``lora`` applies only in the banked form
    (``lora_idx``, each row its own adapter through the grouped (BGMV)
    path); single-adapter callers fold the adapter into ``in_proj`` /
    ``out_proj`` upstream.  ``tp``: as in :func:`mamba_forward`; the
    cache holds this rank's heads of ``h`` and its conv channels, and a
    bank holds ``in_proj``'s ``B`` rows and ``out_proj``'s ``A`` columns
    of the rank."""
    s = cfg.ssm
    H, d_in = _mamba_heads(params, cfg)
    split = tp is not None and tp.mamba
    if split:
        x = tp.copy(x)
    B = x.shape[0]
    if lora_idx is not None:
        proj = grouped_lora_matmul(x, params["in_proj"],
                                   lora.get("in_proj") if lora else None,
                                   lora_idx, lora_scale,
                                   kernel=lora_kernel)[:, 0]
    else:
        proj = (x @ params["in_proj"])[:, 0]                 # [B, proj_out]
    z, xBC, dt = _mamba_split(cfg, proj, H)

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
    y = _gate_norm(y * F.silu(z[:, None, :]), params["gate_norm"], cfg,
                   tp if split else None)
    if lora_idx is not None:
        out = grouped_lora_matmul(y, params["out_proj"],
                                  lora.get("out_proj") if lora else None,
                                  lora_idx, lora_scale, kernel=lora_kernel)
    else:
        out = y @ params["out_proj"]
    return (tp.reduce(out) if split else out), cache


__all__ = ["NEG_INF", "apply_rope", "attention_decode_batch",
           "attention_forward", "cross_kv", "init_attention", "init_mamba", "init_mla",
           "init_mlp", "init_moe", "mamba_decode", "mamba_forward",
           "mla_decode_batch", "mla_forward", "mlp_forward", "moe_capacity",
           "moe_forward", "moe_places", "moe_route", "multihead_attention", "normal",
           "rms_norm", "ssd_chunked"]
