"""Transformer assembly (port of ``repro/models/transformer.py``: init,
LoRA specs, the training forward and masked next-token loss with the MoE
auxiliary loss, the decode cache, single-adapter ``decode_step`` and the
batched multi-adapter ``decode_chunk``) for dense, prefix-VLM, MoE, MLA,
Mamba-2 and hybrid stacks.  Cross-attention VLMs and encoder-decoder
stacks are not ported.

Parameters keep the reference's tree: ``embed``, ``final_ln``, optional
``unembed`` / ``vision_proj``, and ``blocks.s{i}.{ln1, attn | mla | mamba,
ln2, ffn | moe}`` whose leaves are stacked over ``num_blocks`` on their
leading axis.  Where the reference ``lax.scan``s over that axis, the port's
layer loop indexes it.  LoRA trees are ``{"s{i}.attn.wq": {"A": [L, ...],
"B": [L, ...]}, ...}`` with the reference's spec names (``lora_specs``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.lora import LoRASpec
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Tree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def _check_supported(cfg: ModelConfig) -> None:
    if "cross_attn" in cfg.pattern or cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the port covers attn / attn_local / MLA / mamba "
            f"stacks with dense or MoE feed-forwards, not cross-attention "
            f"or enc-dec (pattern {cfg.pattern}, family {cfg.family})")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _init_sublayer(cfg: ModelConfig, kind: str, i: int, g: dict) -> dict:
    """Pattern sublayer ``i``: its norm, its mixer (attention, MLA or
    Mamba) and its feed-forward (MoE on the config's MoE layers, else a
    SwiGLU when ``d_ff > 0``), stacked over the blocks."""
    n, d = cfg.num_blocks, cfg.d_model
    dev, dt = g["device"], g["dtype"]
    p: dict = {"ln1": torch.ones((n, d), device=dev, dtype=dt)}
    if kind in ("attn", "attn_local"):
        if cfg.mla is not None:
            p["mla"] = L.init_mla(cfg, n=n, **g)
        else:
            p["attn"] = L.init_attention(cfg, n=n, **g)
    elif kind == "mamba":
        p["mamba"] = L.init_mamba(cfg, n=n, **g)
    else:
        raise ValueError(kind)
    if cfg.is_moe_layer(i):
        p["ln2"] = torch.ones((n, d), device=dev, dtype=dt)
        p["moe"] = L.init_moe(cfg, n=n, **g)
    elif cfg.d_ff > 0:
        p["ln2"] = torch.ones((n, d), device=dev, dtype=dt)
        p["ffn"] = L.init_mlp(d, cfg.d_ff, n=n, **g)
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0,
                generator: torch.Generator | None = None, device=None,
                dtype=None) -> Tree:
    """Random base weights drawn from a seeded ``torch.Generator`` on
    ``device`` (``None`` = CUDA; raises without one).  The distributions are
    the reference's; the draws are torch's own.  ``dtype`` (default
    ``cfg.dtype``) is every leaf's but the ones the reference keeps in f32
    whatever the config says: the MoE router and Mamba's ``A_log``, ``D``
    and ``dt_bias``."""
    _check_supported(cfg)
    device = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    g = dict(generator=generator, device=device, dtype=dt)
    d = cfg.d_model
    params: dict = {
        "embed": L.normal((cfg.vocab_size, d), 0.02, **g),
        "final_ln": torch.ones((d,), device=device, dtype=dt),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.normal((d, cfg.vocab_size), d ** -0.5, **g)
    params["blocks"] = {f"s{i}": _init_sublayer(cfg, kind, i, g)
                        for i, kind in enumerate(cfg.pattern)}
    if cfg.family == "vlm" and cfg.vision_mode == "prefix":
        params["vision_proj"] = L.normal((cfg.vision_dim, d),
                                         cfg.vision_dim ** -0.5, **g)
    return params


# ---------------------------------------------------------------------------
# LoRA specs — which weights the paper's technique adapts, per family
# ---------------------------------------------------------------------------

def lora_specs(cfg: ModelConfig) -> list[LoRASpec]:
    """Paper: LoRA on the attention query & value projections (the other
    families' sites are listed as the reference lists them)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    n = cfg.num_blocks
    specs: list[LoRASpec] = []
    for i, kind in enumerate(cfg.pattern):
        pre = f"s{i}"
        if kind in ("attn", "attn_local"):
            if cfg.mla is not None:
                m = cfg.mla
                qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                if m.q_lora_rank:
                    specs.append(LoRASpec(f"{pre}.mla.wuq", m.q_lora_rank, h * qd, n))
                else:
                    specs.append(LoRASpec(f"{pre}.mla.wq", d, h * qd, n))
                specs.append(LoRASpec(f"{pre}.mla.wkv_b", m.kv_lora_rank,
                                      h * (m.qk_nope_head_dim + m.v_head_dim), n))
            else:
                specs.append(LoRASpec(f"{pre}.attn.wq", d, h * hd, n))
                specs.append(LoRASpec(f"{pre}.attn.wv", d, kv * hd, n))
        elif kind == "cross_attn":
            specs.append(LoRASpec(f"{pre}.cross.wq", d, h * hd, n))
            specs.append(LoRASpec(f"{pre}.cross.wv", cfg.vision_dim, kv * hd, n))
        elif kind == "mamba":
            s = cfg.ssm
            d_in = s.expand * d
            proj_out = 2 * d_in + 2 * s.state_dim + d_in // s.head_dim
            specs.append(LoRASpec(f"{pre}.mamba.in_proj", d, proj_out, n))
            specs.append(LoRASpec(f"{pre}.mamba.out_proj", d_in, d, n))
        if cfg.family == "encdec":
            specs.append(LoRASpec(f"{pre}.dec_cross.wq", d, h * hd, n))
            specs.append(LoRASpec(f"{pre}.dec_cross.wv", d, kv * hd, n))
    if cfg.family == "encdec":
        specs.append(LoRASpec("enc.attn.wq", d, h * hd, cfg.encoder_layers))
        specs.append(LoRASpec("enc.attn.wv", d, kv * hd, cfg.encoder_layers))
    return specs


def _sub_lora(lora: Tree | None, prefix: str) -> dict:
    """Extract {weight_name: {"A","B"}} for one sublayer from the flat tree."""
    if not lora:
        return {}
    plen = len(prefix) + 1
    return {name[plen:]: entry for name, entry in lora.items()
            if name.startswith(prefix + ".")}


def _layer(tree: Tree, l: int) -> Tree:
    """Views of every leaf at index ``l`` of its leading (block) axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


# ---------------------------------------------------------------------------
# forward (training / evaluation loss)
# ---------------------------------------------------------------------------

def _fold_mamba(mp: dict, lo: dict, lora_scale: float) -> dict:
    """Mamba's projections with one adapter folded in, as the reference
    does at training and single-adapter decode: ``w + s·(B A)ᵀ`` with the
    product cast to the weight's dtype before it is scaled."""
    mp = dict(mp)
    for w in ("in_proj", "out_proj"):
        if w in lo:
            mp[w] = mp[w] + lora_scale * torch.einsum(
                "or,ri->io", lo[w]["B"], lo[w]["A"]).to(mp[w].dtype)
    return mp


def _feed_forward(cfg: ModelConfig, bp: dict, x):
    """The sublayer's residual feed-forward (MoE or SwiGLU, if any):
    returns (x, aux)."""
    if "moe" in bp:
        h2 = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        y, aux = L.moe_forward(bp["moe"], h2, cfg)
        return x + y, aux
    if "ffn" in bp:
        h2 = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + L.mlp_forward(bp["ffn"], h2)
    return x, None


def _run_blocks(cfg: ModelConfig, blocks: Tree, lora: Tree | None, x, *,
                lora_scale: float, positions, pad_mask=None):
    """The block stack over [B, S, d]: per block, each pattern sublayer's
    pre-norm mixer (attention, MLA or Mamba-2) and feed-forward, both
    residual.  Returns (x, the MoE aux losses summed, f32)."""
    lora = {k: v for k, v in (lora or {}).items() if k.startswith("s")}
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.num_blocks):
        bp = _layer(blocks, l)
        lt = _layer(lora, l)
        aux_l = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(cfg.pattern):
            pre, sp = f"s{i}", bp[f"s{i}"]
            h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
            if "mla" in sp:
                y = L.mla_forward(sp["mla"], h, cfg,
                                  lora=_sub_lora(lt, f"{pre}.mla"),
                                  lora_scale=lora_scale, positions=positions,
                                  pad_mask=pad_mask)
            elif "mamba" in sp:
                mp = _fold_mamba(sp["mamba"], _sub_lora(lt, f"{pre}.mamba"),
                                 lora_scale)
                y = L.mamba_forward(mp, h, cfg)
            else:
                y = L.attention_forward(
                    sp["attn"], h, cfg, kind=kind,
                    lora=_sub_lora(lt, f"{pre}.attn"), lora_scale=lora_scale,
                    positions=positions, pad_mask=pad_mask)
            x, aux = _feed_forward(cfg, sp, x + y)
            if aux is not None:
                aux_l = aux_l + aux
        aux_tot = aux_tot + aux_l
    return x, aux_tot


def forward(cfg: ModelConfig, params: Tree, tokens, *, lora=None,
            lora_scale: float = 1.0, vision=None, pad_mask=None,
            last_only: bool = False):
    """Training / prefill forward.  ``vision`` [B, P, vision_dim] is
    projected into a P-position prefix ahead of the text (prefix VLM).
    Returns (logits [B, S, V] — [B, 1, V] with ``last_only`` —, the MoE
    aux loss: a 0-d f32 tensor, 0 without MoE layers)."""
    _check_supported(cfg)
    x = params["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)
    n_prefix = 0
    if cfg.family == "vlm" and vision is not None:
        pre = vision.to(x.dtype) @ params["vision_proj"]        # [B, P, d]
        x = torch.cat([pre, x], dim=1)
        n_prefix = pre.shape[1]
        positions = torch.arange(S + n_prefix, device=x.device)
        if pad_mask is not None:
            pad_mask = torch.cat([pad_mask.new_ones((B, n_prefix)),
                                  pad_mask], dim=1)
    x, aux = _run_blocks(cfg, params["blocks"], lora, x,
                         lora_scale=lora_scale, positions=positions,
                         pad_mask=pad_mask)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    if last_only:
        x = x[:, -1:]
    if cfg.tie_embeddings:
        return x @ params["embed"].T, aux
    return x @ params["unembed"], aux


def loss_fn(cfg: ModelConfig, params: Tree, lora: Tree | None, batch: dict,
            lora_scale: float = 1.0):
    """Masked next-token cross-entropy plus the MoE aux loss.  ``batch``:
    tokens, labels, loss_mask, optional image and image_mask (a zero
    ``image_mask`` row zeroes that example's vision prefix: the
    missing-modality path).  Returns (loss + aux, {"loss", "aux",
    "acc"}), all 0-d f32 tensors."""
    vision = batch.get("image")
    if vision is not None and "image_mask" in batch:
        vision = (vision * batch["image_mask"][:, None, None]).to(vision.dtype)
    logits, aux = forward(cfg, params, batch["tokens"], lora=lora,
                          lora_scale=lora_scale, vision=vision)
    logits = logits.float()
    logp = F.log_softmax(logits, dim=-1)
    labels = batch["labels"].long()
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch["loss_mask"].float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = -(ll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return loss + aux, {"loss": loss, "aux": aux, "acc": acc}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, params: Tree, batch: int,
               max_len: int) -> Tree:
    """Zeroed per-sublayer decode state, stacked over blocks, on the device
    and in the dtype of ``params["embed"]``: attention K/V ``{"k","v": [n,
    batch, S, KV, D]}`` (local layers hold a ring of ``min(max_len,
    sliding_window)`` rows), MLA's compressed ``{"c_kv": [n, batch,
    max_len, c], "k_rope": [n, batch, max_len, rd]}``, Mamba's ``{"h": [n,
    batch, H, P, N] f32, "conv": [n, batch, W-1, C]}``.  A zero row is a
    fresh row of every kind."""
    _check_supported(cfg)
    ref = params["embed"]
    kv, hd, n = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_blocks
    cache: dict = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "mamba":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            cache[f"s{i}"] = {
                "h": ref.new_zeros((n, batch, d_in // s.head_dim, s.head_dim,
                                    s.state_dim), dtype=torch.float32),
                "conv": ref.new_zeros((n, batch, s.conv_width - 1,
                                       d_in + 2 * s.state_dim))}
        elif cfg.mla is not None:
            m = cfg.mla
            cache[f"s{i}"] = {
                "c_kv": ref.new_zeros((n, batch, max_len, m.kv_lora_rank)),
                "k_rope": ref.new_zeros((n, batch, max_len,
                                         m.qk_rope_head_dim))}
        else:
            S = max_len
            if kind == "attn_local" and cfg.sliding_window:
                S = min(max_len, cfg.sliding_window)
            shape = (n, batch, S, kv, hd)
            cache[f"s{i}"] = {"k": ref.new_zeros(shape),
                              "v": ref.new_zeros(shape)}
    return cache


def decode_step(cfg: ModelConfig, params: Tree, cache: Tree, tokens, pos, *,
                lora=None, lora_scale: float = 1.0, embeds=None):
    """One-token decode with one adapter for the whole batch.  ``tokens``
    int [B] (or ``embeds`` [B, 1, d], which replaces the token embedding —
    the vision prefix streams through it); ``pos``: int, the current
    position.  ``lora`` leaves are [L, ...] (the training layout); on Mamba
    layers it folds into the projections, as the reference's
    ``decode_step`` does.  The cache is updated in place.  Returns (logits
    f32 [B, V], cache)."""
    x = embeds if embeds is not None else params["embed"][tokens][:, None, :]
    p = torch.full((x.shape[0],), int(pos), dtype=torch.long, device=x.device)
    return decode_chunk(cfg, params, cache, x, p, adapters=lora,
                        lora_scale=lora_scale)


def decode_chunk(cfg: ModelConfig, params: Tree, cache: Tree, embeds, pos, *,
                 adapters=None, adapter_idx=None, lora_scale: float = 1.0,
                 valid=None, lora_kernel: bool = False, logits: bool = True,
                 chunked: bool | None = False):
    """Batched multi-adapter decode over ``C`` positions per row — the
    serving hot path (``C = 1``: one-token decode; ``C = chunk``: chunked
    prefill).

    ``embeds``: [B, C, d]; ``pos``: [B] per-row first position; ``valid``:
    optional [B, C] ragged-tail mask.  ``adapters``: LoRA bank with leaves
    [L, G, ...] (scan-major); ``adapter_idx``: int [B] per-row bank index
    (``None``: ``adapters`` is one adapter, leaves [L, ...], for every
    row).  ``lora_kernel=True`` routes every banked LoRA site (attention
    ``wq`` / ``wv``, MLA's q side, Mamba's ``in_proj`` / ``out_proj``)
    through the BGMV kernel; MLA's ``wkv_b`` folds per bank entry.  Mamba
    layers take C = 1 only (a recurrent state cannot skip masked chunk
    tails).  MoE layers route every row of the batch, free slots too, as
    the reference does.  ``logits=False`` skips the final norm and unembed
    (required when C > 1).  ``cache`` (``init_cache`` layout) is updated in
    place and returned.  Returns (logits f32 [B, V] | None, cache).

    With one adapter (``adapter_idx=None``) it folds into the Mamba
    projections here; the reference's ``decode_chunk`` drops it on Mamba
    layers, and only its ``decode_step`` folds it."""
    C = embeds.shape[1]
    if logits and C != 1:
        raise ValueError("logits=True needs C == 1 (prefill discards them)")
    _check_supported(cfg)
    bank = adapters if adapters is not None else {}
    h = embeds
    for l in range(cfg.num_blocks):
        bp = _layer(params["blocks"], l)
        lt = _layer(bank, l)
        for i, kind in enumerate(cfg.pattern):
            pre, sp = f"s{i}", bp[f"s{i}"]
            hn = L.rms_norm(h, sp["ln1"], cfg.norm_eps)
            ci = {k: c[l] for k, c in cache[pre].items()}
            if "mamba" in sp:
                if C != 1:
                    raise NotImplementedError(
                        "chunked prefill over a recurrent mamba state is "
                        "not supported (engine gates it)")
                lo = _sub_lora(lt, f"{pre}.mamba")
                if adapter_idx is None:
                    y, _ = L.mamba_decode(_fold_mamba(sp["mamba"], lo,
                                                      lora_scale), hn, ci, cfg)
                else:
                    y, _ = L.mamba_decode(
                        sp["mamba"], hn, ci, cfg, lora=lo,
                        lora_scale=lora_scale, lora_idx=adapter_idx,
                        lora_kernel=lora_kernel)
            elif "mla" in sp:
                y, _ = L.mla_decode_batch(
                    sp["mla"], hn, ci, cfg, pos=pos, valid=valid,
                    lora=_sub_lora(lt, f"{pre}.mla"), lora_scale=lora_scale,
                    lora_idx=adapter_idx, lora_kernel=lora_kernel)
            else:
                y, _ = L.attention_decode_batch(
                    sp["attn"], hn, ci, cfg, kind=kind, pos=pos, valid=valid,
                    lora=_sub_lora(lt, f"{pre}.attn"), lora_scale=lora_scale,
                    lora_idx=adapter_idx, lora_kernel=lora_kernel,
                    chunked=chunked)
            h, _ = _feed_forward(cfg, sp, h + y)
    if not logits:
        return None, cache
    x = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        out = x[:, 0] @ params["embed"].T
    else:
        out = x[:, 0] @ params["unembed"]
    return out.float(), cache


__all__ = ["decode_chunk", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "lora_specs", "torch_dtype"]
