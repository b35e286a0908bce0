"""Transformer assembly (port of ``repro/models/transformer.py``: init,
LoRA specs, the training forward and masked next-token loss with the MoE
auxiliary loss, the encoder of enc-dec stacks, the decode cache,
single-adapter ``decode_step`` and the batched multi-adapter
``decode_chunk``) for every family: dense, prefix and cross-attention VLMs,
MoE, MLA, Mamba-2, hybrid and encoder-decoder stacks.

Parameters keep the reference's tree: ``embed``, ``final_ln``, optional
``unembed`` / ``vision_proj`` / ``encoder`` (``in_proj``, ``final_ln``,
``blocks.s0`` stacked over ``encoder_layers``), and ``blocks.s{i}.{ln1,
attn | mla | mamba | cross, [lnx, dec_cross,] ln2, ffn | moe}`` whose
leaves are stacked over ``num_blocks`` on their leading axis.  Where the
reference ``lax.scan``s over that axis, the port's layer loop indexes it.
LoRA trees are ``{"s{i}.attn.wq": {"A": [L, ...], "B": [L, ...]}, ...}``
with the reference's spec names (``lora_specs``); the ``enc.*`` entries
stack over the encoder's layers and stay out of the block loop.

Where the reference's decode cache drops an adapter, the port applies it:
``init_cache`` builds the static cross K/V with ``cross.wv``'s and
``dec_cross.wv``'s LoRA and encodes the audio with the ``enc.*`` entries,
so a cached decode equals the forward with an adapter on every site.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.lora import LoRASpec
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.telemetry import span

Tree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _init_sublayer(cfg: ModelConfig, kind: str, i: int, g: dict,
                   n: int | None = None) -> dict:
    """Pattern sublayer ``i``: its norm, its mixer (attention, MLA, gated
    cross-attention or Mamba) and its feed-forward (MoE on the config's MoE
    layers, else a SwiGLU when ``d_ff > 0``), stacked over ``n`` layers
    (default the blocks)."""
    n, d = n or cfg.num_blocks, cfg.d_model
    dev, dt = g["device"], g["dtype"]
    p: dict = {"ln1": torch.ones((n, d), device=dev, dtype=dt)}
    if kind in ("attn", "attn_local"):
        if cfg.mla is not None:
            p["mla"] = L.init_mla(cfg, n=n, **g)
        else:
            p["attn"] = L.init_attention(cfg, n=n, **g)
    elif kind == "cross_attn":
        p["cross"] = L.init_attention(cfg, n=n, cross=True, **g)
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
                dtype=None, tp=None) -> Tree:
    """Random base weights drawn from a seeded ``torch.Generator`` on
    ``device`` (``None`` = CUDA; raises without one).  The distributions are
    the reference's; the draws are torch's own.  ``dtype`` (default
    ``cfg.dtype``) is every leaf's but the ones the reference keeps in f32
    whatever the config says: the MoE router and Mamba's ``A_log``, ``D``
    and ``dt_bias``.  A vision cross layer's gate starts closed (0), as
    the reference's does.

    ``tp`` (a ``TensorParallel``): this rank's pieces of the same tree
    (the same draws in the same order), each sublayer cut as soon as it
    is drawn, so no more than one sublayer is ever whole on the device — a
    model larger than one device's memory starts on its mesh this way."""
    device = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    g = dict(generator=generator, device=device, dtype=dt)
    cut = (lambda t: t) if tp is None else tp.shard_params
    d = cfg.d_model
    params: dict = cut({
        "embed": L.normal((cfg.vocab_size, d), 0.02, **g),
        "final_ln": torch.ones((d,), device=device, dtype=dt),
    })
    if not cfg.tie_embeddings:
        params.update(cut({"unembed": L.normal((d, cfg.vocab_size),
                                               d ** -0.5, **g)}))
    params["blocks"] = {f"s{i}": cut(_init_sublayer(cfg, kind, i, g))
                        for i, kind in enumerate(cfg.pattern)}
    if cfg.family == "vlm" and cfg.vision_mode == "prefix":
        params.update(cut({"vision_proj": L.normal(
            (cfg.vision_dim, d), cfg.vision_dim ** -0.5, **g)}))
    if cfg.family == "encdec":
        params["encoder"] = cut({"encoder": {
            "in_proj": L.normal((cfg.audio_dim, d), cfg.audio_dim ** -0.5,
                                **g),
            "final_ln": torch.ones((d,), device=device, dtype=dt)}}
        )["encoder"]
        params["encoder"]["blocks"] = {"s0": cut(_init_sublayer(
            cfg, "attn", 0, g, n=cfg.encoder_layers))}
        # the decoder's ungated cross-attention over the encoder output
        for sp in params["blocks"].values():
            sp["lnx"] = torch.ones((cfg.num_blocks, d), device=device,
                                   dtype=dt)
            sp.update(cut({"dec_cross": L.init_attention(
                cfg, n=cfg.num_blocks, kv_in=d, **g)}))
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


def _feed_forward(cfg: ModelConfig, bp: dict, x, tp=None):
    """The sublayer's residual feed-forward (MoE or SwiGLU, if any):
    returns (x, aux)."""
    for key in ("moe", "ffn"):
        if key in bp:
            y, aux = _piece(cfg, None, key,
                            L.rms_norm(x, bp["ln2"], cfg.norm_eps), bp[key],
                            {}, tp=tp)
            return x + y, aux
    return x, None


def _run_blocks(cfg: ModelConfig, blocks: Tree, lora: Tree | None, x, *,
                lora_scale: float, positions, pad_mask=None, vision=None,
                enc_out=None, enc_mask=None, tp=None, remat: bool = False):
    """The block stack over ``x`` [B, S, d] (or a one-item list holding
    it, which the stack then owns: with no other reference the input is
    freed once the first block is done with it): per block, each pattern
    sublayer's pre-norm mixer (attention, MLA, gated cross-attention over
    ``vision`` or Mamba-2), on enc-dec stacks the cross-attention over
    ``enc_out`` (keys masked by ``enc_mask``), and the feed-forward, all
    residual.
    Only the block-stacked ``s*`` LoRA entries ride the loop.  Returns (x,
    the MoE aux losses summed, f32).  ``tp``: every sublayer runs its
    rank's pieces (``repro_torch.models.tensor_parallel``).  ``remat``:
    each block runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` around its scan body), so the backward keeps only
    the blocks' inputs and recomputes each block's activations (and its
    collectives) once more."""
    if isinstance(x, list):
        x = x.pop()
    lora = {k: v for k, v in (lora or {}).items() if k.startswith("s")}
    if enc_out is not None and tp is not None and (tp.attn or tp.sp):
        enc_out = tp.copy(enc_out)     # its gradient: the ranks' partials
    if tp is not None and tp.sp:
        return _run_blocks_sp(cfg, blocks, lora, x, lora_scale=lora_scale,
                              positions=positions, pad_mask=pad_mask,
                              vision=vision, enc_out=enc_out,
                              enc_mask=enc_mask, tp=tp, remat=remat)
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    block = lambda x, bp, lt: _block(cfg, bp, lt, x, lora_scale=lora_scale,
                                     positions=positions, pad_mask=pad_mask,
                                     vision=vision, enc_out=enc_out,
                                     enc_mask=enc_mask, tp=tp)
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        run = lambda x, bp, lt: checkpoint(block, x, bp, lt,
                                           use_reentrant=False,
                                           preserve_rng_state=False)
    else:
        run = block
    for l in range(cfg.num_blocks):
        x, aux_l = run(x, _layer(blocks, l), _layer(lora, l))
        aux_tot = aux_tot + aux_l
        del aux_l          # every block then runs beside the same live set
    return x, aux_tot


def _block(cfg: ModelConfig, bp: Tree, lt: Tree, x, *, lora_scale: float,
           positions, pad_mask, vision, enc_out, enc_mask, tp):
    """One block of :func:`_run_blocks`: returns (x, its MoE aux, f32).
    Under FSDP (``tp.fsdp``) each piece's weights are gathered here, so
    that a remat recompute gathers them again and nothing outlives the
    block."""
    ctx = dict(lora_scale=lora_scale, positions=positions, pad_mask=pad_mask,
               vision=vision, enc_out=enc_out, enc_mask=enc_mask, tp=tp)
    aux_l = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(cfg.pattern):
        pre, sp = f"s{i}", bp[f"s{i}"]
        for key, norm in _pieces(sp):
            p = sp[key] if tp is None else tp.gather(sp[key], key)
            y, aux = _piece(cfg, kind, key,
                            L.rms_norm(x, sp[norm], cfg.norm_eps), p,
                            _sub_lora(lt, f"{pre}.{key}"), **ctx)
            x = x + y
            if aux is not None:
                aux_l = aux_l + aux
    return x, aux_l


def _pieces(sp: dict) -> list:
    """The residual pieces of one pattern sublayer, in order — the mixer,
    an enc-dec stack's cross layer and the feed-forward —, each as ``(key,
    norm)``: its params' key and its norm's key."""
    mixer = next((k for k in ("mla", "mamba", "cross") if k in sp), "attn")
    out = [(mixer, "ln1")]
    if "dec_cross" in sp:
        out.append(("dec_cross", "lnx"))
    ffn = next((k for k in ("moe", "ffn") if k in sp), None)
    if ffn is not None:
        out.append((ffn, "ln2"))
    return out


# piece -> the plan's flag that splits it
_SPLIT_BY = {"mla": "mla", "mamba": "mamba", "cross": "attn", "attn": "attn",
             "dec_cross": "attn", "ffn": "mlp"}


def _piece(cfg: ModelConfig, kind, key: str, h, p, lo, *, lora_scale=1.0,
           positions=None, pad_mask=None, vision=None, enc_out=None,
           enc_mask=None, tp=None, sp: bool = False):
    """One residual piece on its normed input ``h``, with its params ``p``
    (whole over ``"data"``) and adapters ``lo``: returns (y, aux), ``aux``
    the MoE's or ``None``.  ``sp``: the piece runs between the sequence
    parallel collectives, so its split products run under ``tp.inner`` and
    its output is left as the ranks' partial sums."""
    sub = tp.inner if sp else tp
    if key == "moe":
        return L.moe_forward(p, h, cfg, tp, reduce=not sp)
    if key == "ffn":
        return L.mlp_forward(p, h, sub), None
    if key == "mla":
        return L.mla_forward(p, h, cfg, lora=lo, lora_scale=lora_scale,
                             positions=positions, pad_mask=pad_mask,
                             tp=sub), None
    if key == "mamba":
        return L.mamba_forward(_fold_mamba(p, lo, lora_scale), h, cfg,
                               sub), None
    if key in ("cross", "dec_cross"):
        return L.attention_forward(
            p, h, cfg, kind="cross_attn", lora=lo, lora_scale=lora_scale,
            kv_src=vision if key == "cross" else enc_out,
            pad_mask=None if key == "cross" else enc_mask, tp=sub), None
    return L.attention_forward(p, h, cfg, kind=kind, lora=lo,
                               lora_scale=lora_scale, positions=positions,
                               pad_mask=pad_mask, tp=sub), None


def _sp_piece(cfg: ModelConfig, kind: str, key: str, moe: bool, x, p, ln,
              lo, **ctx):
    """One residual piece under sequence parallelism, up to its output
    before the reduce-scatter: ``x`` this rank's rows, ``p`` the piece's
    params (gathered here under FSDP, so a remat recompute gathers them
    again), ``ln`` its norm.  The MoE's router and gates run on every
    rank, so its gathered input's gradient is whole for each rank's own
    rows and is sliced, not reduce-scattered.  Returns (y, aux): ``y``
    ``[B, S, d]`` whole or the ranks' partial sums."""
    tp = ctx["tp"]
    h = tp.sp_gather(L.rms_norm(x, ln, cfg.norm_eps),
                     grad="slice" if moe else "reduce_scatter")
    return _piece(cfg, kind, key, h, tp.gather(p, key), lo, sp=True, **ctx)


def _run_blocks_sp(cfg: ModelConfig, blocks: Tree, lora: dict, x, *,
                   lora_scale: float, positions, pad_mask, vision, enc_out,
                   enc_mask, tp, remat: bool):
    """:func:`_run_blocks` under sequence parallelism (the Megatron
    pattern over ``tp.axis``): the residual stream is this rank's
    ``[B, S/n, d]`` rows; norms and residual adds run on them; each
    piece's input is all-gathered over the sequence (its gradient
    reduce-scattered) and a split piece's row-parallel output
    reduce-scattered (its gradient all-gathered); a whole piece (Mamba's
    scan, an unsplit attention) runs on the gathered input and keeps its
    rows.  ``remat``: each piece up to its output runs under
    ``torch.utils.checkpoint``, so the recompute gathers its input (and
    its FSDP weights) again while the reduce-scatter, outside, runs once.
    Returns the whole ``[B, S, d]`` (gathered; its gradient sliced) and
    the aux losses."""
    tp.sp_check(x.shape[1])
    x = tp.sp_rows(x)
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    ctx = dict(lora_scale=lora_scale, positions=positions, pad_mask=pad_mask,
               vision=vision, enc_out=enc_out, enc_mask=enc_mask, tp=tp)
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        run = lambda fn, *a: checkpoint(fn, *a, use_reentrant=False,
                                        preserve_rng_state=False)
    else:
        run = lambda fn, *a: fn(*a)
    for l in range(cfg.num_blocks):
        bp, lt = _layer(blocks, l), _layer(lora, l)
        aux_l = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(cfg.pattern):
            pre, sp = f"s{i}", bp[f"s{i}"]
            for key, norm in _pieces(sp):
                moe = key == "moe"
                fn = (lambda x, p, ln, lo, kind=kind, key=key, moe=moe:
                      _sp_piece(cfg, kind, key, moe, x, p, ln, lo, **ctx))
                y, aux = run(fn, x, sp[key], sp[norm],
                             _sub_lora(lt, f"{pre}.{key}"))
                # a split piece's (the experts', too) row-parallel output
                # is reduce-scattered; a whole piece keeps its rows
                if tp.moe if moe else getattr(tp, _SPLIT_BY[key]):
                    y = tp.sp_scatter(y)
                else:
                    y = tp.sp_rows(y)
                x = x + y
                if aux is not None:
                    aux_l = aux_l + aux
                del y, aux
        aux_tot = aux_tot + aux_l
        del aux_l
    return tp.sp_gather(x, grad="slice"), aux_tot


def encode(cfg: ModelConfig, params: Tree, audio, lora=None,
           lora_scale: float = 1.0, audio_mask=None, tp=None):
    """The enc-dec encoder: ``audio`` [B, P, audio_dim] frame embeddings
    through ``encoder_layers`` bidirectional self-attention layers (RoPE,
    keys masked by ``audio_mask`` [B, P]) with the ``enc.attn.wq`` /
    ``enc.attn.wv`` adapters, then the final norm.  Returns [B, P, d].
    ``tp``: the layers' attention and MLP run the rank's pieces; the
    frontend ``in_proj`` is whole, and so is the output."""
    enc = params["encoder"]
    in_proj = enc["in_proj"] if tp is None else tp.full("encoder", "in_proj",
                                                        enc["in_proj"])
    x = audio.to(in_proj.dtype) @ in_proj
    lora = {k[len("enc."):]: v for k, v in (lora or {}).items()
            if k.startswith("enc.")}
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    for l in range(cfg.encoder_layers):
        bp = _layer(enc["blocks"]["s0"], l)
        if tp is not None:
            bp = tp.gather(bp, "s0")
        lt = _sub_lora(_layer(lora, l), "attn")
        hn = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        split = tp is not None and tp.attn
        if split:
            hn = tp.copy(hn)
        q, k, v = L._qkv(bp["attn"], hn, hn, cfg, lt, lora_scale)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        o = L.multihead_attention(q, k, v, causal=False, pad_mask=audio_mask)
        y = o.reshape(x.shape[0], S, -1) @ bp["attn"]["wo"]
        x = x + (tp.reduce(y) if split else y)
        x = x + L.mlp_forward(bp["ffn"], L.rms_norm(x, bp["ln2"],
                                                    cfg.norm_eps), tp)
    return L.rms_norm(x, enc["final_ln"], cfg.norm_eps)


def forward(cfg: ModelConfig, params: Tree, tokens, *, lora=None,
            lora_scale: float = 1.0, vision=None, audio=None, pad_mask=None,
            audio_mask=None, last_only: bool = False, tp=None,
            remat: bool = False):
    """Training / prefill forward.  ``vision`` [B, P, vision_dim]: a prefix
    VLM projects it into a P-position prefix ahead of the text; a cross
    VLM's gated cross layers attend to it.  ``audio`` [B, P, audio_dim]
    (enc-dec): the encoder's input, its frames masked by ``audio_mask``.
    Returns (logits [B, S, V] — [B, 1, V] with ``last_only`` —, the MoE
    aux loss: a 0-d f32 tensor, 0 without MoE layers).

    ``tp`` (``repro_torch.models.tensor_parallel.TensorParallel``): the
    params and ``lora`` are this rank's pieces (``tp.shard_params``,
    ``tp.local_lora``) and the logits its vocabulary columns.  ``remat``:
    the blocks recompute their activations in the backward
    (:func:`_run_blocks`)."""
    x = (params["embed"][tokens] if tp is None
         else tp.embed(params["embed"], tokens))
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)
    n_prefix = 0
    if cfg.family == "vlm" and cfg.vision_mode == "prefix" \
            and vision is not None:
        vp = params["vision_proj"] if tp is None else tp.full(
            "", "vision_proj", params["vision_proj"])
        pre = vision.to(x.dtype) @ vp                           # [B, P, d]
        x = torch.cat([pre, x], dim=1)
        n_prefix = pre.shape[1]
        positions = torch.arange(S + n_prefix, device=x.device)
        if pad_mask is not None:
            pad_mask = torch.cat([pad_mask.new_ones((B, n_prefix)),
                                  pad_mask], dim=1)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = encode(cfg, params, audio, lora, lora_scale, audio_mask,
                         tp)
    held = [x]           # the stack takes the only reference (see _run_blocks)
    del x
    x, aux = _run_blocks(cfg, params["blocks"], lora, held,
                         lora_scale=lora_scale, positions=positions,
                         pad_mask=pad_mask,
                         vision=vision if cfg.vision_mode == "cross" else None,
                         enc_out=enc_out, enc_mask=audio_mask, tp=tp,
                         remat=remat)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    if last_only:
        x = x[:, -1:]
    if tp is not None:
        return tp.logits(x, params), aux
    if cfg.tie_embeddings:
        return x @ params["embed"].T, aux
    return x @ params["unembed"], aux


def loss_fn(cfg: ModelConfig, params: Tree, lora: Tree | None, batch: dict,
            lora_scale: float = 1.0, tp=None, remat: bool = False,
            mask_count=None):
    """Masked next-token cross-entropy plus the MoE aux loss.  ``batch``:
    tokens, labels, loss_mask, optional image and image_mask (a zero
    ``image_mask`` row zeroes that example's vision input: the
    missing-modality path) and audio (enc-dec).  Returns (loss + aux,
    {"loss", "aux", "acc"}), all 0-d f32 tensors.  ``tp``: as in
    :func:`forward`; the log-softmax and the argmax then span every rank's
    vocabulary columns.  ``remat``: as in :func:`forward`.

    ``mask_count``: the mask count that divides ``loss`` and ``acc``
    (default: ``batch``'s own).  A batch-sharded step passes the whole
    reference batch's, so that with this rank's rows of it ``loss`` and
    ``acc`` are this rank's share of the global values (their sum over the
    ranks); with a batch-sharded ``tp`` (``tp.batched``) ``aux`` is the
    global batch's (:func:`repro_torch.models.layers.moe_forward`)."""
    vision = batch.get("image")
    if vision is not None and "image_mask" in batch:
        vision = (vision * batch["image_mask"][:, None, None]).to(vision.dtype)
    logits, aux = forward(cfg, params, batch["tokens"], lora=lora,
                          lora_scale=lora_scale, vision=vision,
                          audio=batch.get("audio"), tp=tp, remat=remat)
    logits = logits.float()
    labels = batch["labels"].long()
    if tp is None:
        logp = F.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        hit = logits.argmax(-1) == labels
    else:
        ll, hit = tp.log_prob(logits, labels)
    mask = batch["loss_mask"].float()
    denom = torch.clamp(mask.sum() if mask_count is None else mask_count,
                        min=1.0)
    loss = -(ll * mask).sum() / denom
    acc = (hit * mask).sum() / denom
    return loss + aux, {"loss": loss, "aux": aux, "acc": acc}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _static_kv(cfg: ModelConfig, stacked: Tree, src, lora, lora_scale,
               tp=None, parent: str = "cross"):
    """A cross sublayer's static cache ``{"k","v": [n, B, P, KV, D]}``
    from ``src``, layer by layer, with ``lora`` (leaves [n, ...])."""
    gather = (lambda p: p) if tp is None else (lambda p: tp.gather(p, parent))
    ks, vs = zip(*(L.cross_kv(gather(_layer(stacked, l)), src, cfg,
                              _layer(lora, l), lora_scale)
                   for l in range(cfg.num_blocks)))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def init_cache(cfg: ModelConfig, params: Tree, batch: int, max_len: int, *,
               vision=None, audio=None, lora=None,
               lora_scale: float = 1.0, tp=None, cache_axis=None) -> Tree:
    """Per-sublayer decode state, stacked over blocks, on the device and in
    the dtype of ``params["embed"]``: attention K/V ``{"k","v": [n, batch,
    S, KV, D]}`` (local layers hold a ring of ``min(max_len,
    sliding_window)`` rows), MLA's compressed ``{"c_kv": [n, batch,
    max_len, c], "k_rope": [n, batch, max_len, rd]}``, Mamba's ``{"h": [n,
    batch, H, P, N] f32, "conv": [n, batch, W-1, C]}``, all zero (a zero
    row is a fresh row of every kind).

    The static caches, under the reference's keys: a cross VLM's ``s{i}``
    holds the K/V of ``vision`` [batch, P, vision_dim], an enc-dec stack's
    ``s{i}_dec_cross`` those of the encoded ``audio``.  Unlike the
    reference's, they carry ``lora``'s adapter (``cross.wv``,
    ``dec_cross.wv`` and the encoder's ``enc.*``), so that the decode with
    that adapter equals the forward.

    ``tp``: ``params`` and ``lora`` are a tensor-parallel rank's pieces
    (``lora`` through ``tp.local_lora``), and every head count and width
    comes from the weights: the rank's K/V heads (static ones too) and
    Mamba heads of ``h`` and conv channels; MLA's latents stay whole.

    ``cache_axis`` (an axis of ``tp``'s mesh, of size ``m``; see
    ``repro_torch.sharding.decode_cache_axis``): every attention K/V cache
    (a local layer's ring too) and MLA latent holds this rank's block of
    ``1 / m`` of its positions — every K/V head on ``"model"`` (the
    ``seq`` placement), the rank's heads on ``"data"`` (the long-context
    fallback).  Each length must divide ``m``.  The static cross caches
    and Mamba's state keep their placement."""
    ref = params["embed"]
    hd, n = cfg.resolved_head_dim, cfg.num_blocks
    m = 1 if cache_axis is None else tp.mesh.shape[cache_axis]

    def seq(S: int) -> int:
        if S % m:
            raise ValueError(f"a decode cache of {S} positions does not "
                             f"split over the {cache_axis!r} axis ({m})")
        return S // m

    cache: dict = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "cross_attn":
            cache[f"s{i}"] = _static_kv(
                cfg, params["blocks"][f"s{i}"]["cross"], vision,
                _sub_lora(lora, f"s{i}.cross"), lora_scale, tp)
        elif kind == "mamba":
            s, mp = cfg.ssm, params["blocks"][f"s{i}"]["mamba"]
            cache[f"s{i}"] = {
                "h": ref.new_zeros((n, batch, mp["A_log"].shape[-1],
                                    s.head_dim, s.state_dim),
                                   dtype=torch.float32),
                "conv": ref.new_zeros((n, batch, s.conv_width - 1,
                                       mp["conv_w"].shape[-1]))}
        elif cfg.mla is not None:
            ml = cfg.mla
            cache[f"s{i}"] = {
                "c_kv": ref.new_zeros((n, batch, seq(max_len),
                                       ml.kv_lora_rank)),
                "k_rope": ref.new_zeros((n, batch, seq(max_len),
                                         ml.qk_rope_head_dim))}
        else:
            S = max_len
            if kind == "attn_local" and cfg.sliding_window:
                S = min(max_len, cfg.sliding_window)
            # the K/V heads of these weights (a tensor-parallel rank's own;
            # every head in a cache split over "model")
            kv = params["blocks"][f"s{i}"]["attn"]["wk"].shape[-1] // hd
            if cache_axis == "model":
                kv = cfg.num_kv_heads
            shape = (n, batch, seq(S), kv, hd)
            cache[f"s{i}"] = {"k": ref.new_zeros(shape),
                              "v": ref.new_zeros(shape)}
    if cfg.family == "encdec":
        enc_out = encode(cfg, params, audio, lora, lora_scale, tp=tp)
        for i in range(cfg.period):
            cache[f"s{i}_dec_cross"] = _static_kv(
                cfg, params["blocks"][f"s{i}"]["dec_cross"], enc_out,
                _sub_lora(lora, f"s{i}.dec_cross"), lora_scale, tp,
                "dec_cross")
    return cache


def decode_step(cfg: ModelConfig, params: Tree, cache: Tree, tokens, pos, *,
                lora=None, lora_scale: float = 1.0, embeds=None, tp=None,
                cache_axis=None, score_axis=None):
    """One-token decode with one adapter for the whole batch.  ``tokens``
    int [B] (or ``embeds`` [B, 1, d], which replaces the token embedding —
    the vision prefix streams through it); ``pos``: int, the current
    position.  ``lora`` leaves are [L, ...] (the training layout); on Mamba
    layers it folds into the projections, as the reference's
    ``decode_step`` does.  The cache is updated in place.  Returns (logits
    f32 [B, V], cache); with ``tp`` (see :func:`decode_chunk`) the logits
    are this rank's vocabulary columns.  ``cache_axis``: the cache of
    :func:`init_cache` with that axis; ``score_axis``: the ``scoreshard``
    placement of MLA's scores (the reference's ``seq_axis``), ignored by
    every other mixer, as the reference ignores it."""
    if embeds is not None:
        x = embeds
    elif tp is None:
        x = params["embed"][tokens][:, None, :]
    else:
        x = tp.embed(params["embed"], tokens)[:, None, :]
    p = torch.full((x.shape[0],), int(pos), dtype=torch.long, device=x.device)
    return decode_chunk(cfg, params, cache, x, p, adapters=lora,
                        lora_scale=lora_scale, tp=tp, cache_axis=cache_axis,
                        score_axis=score_axis)


def decode_chunk(cfg: ModelConfig, params: Tree, cache: Tree, embeds, pos, *,
                 adapters=None, adapter_idx=None, lora_scale: float = 1.0,
                 valid=None, lora_kernel: bool = False, logits: bool = True,
                 chunked: bool | None = False, tp=None, cache_axis=None,
                 score_axis=None):
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
    layers, and only its ``decode_step`` folds it.  One adapter also
    serves a cross VLM's gated layers and an enc-dec stack's decoder
    cross layers, over the static caches of ``init_cache`` (which must
    carry that adapter's ``cross.wv`` / ``dec_cross.wv`` / ``enc.*``
    entries); with a bank both families raise, as the reference does.

    ``tp`` (a ``TensorParallel``): ``params``, the adapters and the cache
    hold this rank's pieces (its heads, its ``d_ff`` and expert columns,
    a bank's ``B`` rows at the column-parallel sites and ``A`` columns at
    Mamba's row-parallel ``out_proj``) and the logits are its vocabulary
    columns; under FSDP each layer's weights are gathered as it runs.
    ``cache_axis`` / ``score_axis``: as in :func:`decode_step`.

    Under a runtime's current telemetry each sublayer's pre-norm and mixer
    run in a ``mamba_mixer`` or ``attn_mixer`` span, its feed-forward in a
    ``moe`` (or ``ffn``) span, and the final norm and unembed in
    ``serve_head``."""
    C = embeds.shape[1]
    if logits and C != 1:
        raise ValueError("logits=True needs C == 1 (prefill discards them)")
    if adapter_idx is not None:
        if cfg.family == "encdec":
            raise NotImplementedError("enc-dec stacks are engine-gated")
        if "cross_attn" in cfg.pattern:
            raise NotImplementedError(
                "batched decode does not support 'cross_attn'")
    bank = {k: v for k, v in (adapters or {}).items() if k.startswith("s")}
    h = embeds
    for l in range(cfg.num_blocks):
        bp = _layer(params["blocks"], l)
        if tp is not None:
            bp = tp.gather(bp)
        lt = _layer(bank, l)
        for i, kind in enumerate(cfg.pattern):
            pre, sp = f"s{i}", bp[f"s{i}"]
            # the sublayer's pre-norm and mixer
            with span("mamba_mixer" if "mamba" in sp else "attn_mixer"):
                hn = L.rms_norm(h, sp["ln1"], cfg.norm_eps)
                ci = {k: c[l] for k, c in cache[pre].items()}
                if "mamba" in sp:
                    if C != 1:
                        raise NotImplementedError(
                            "chunked prefill over a recurrent mamba state is "
                            "not supported (engine gates it)")
                    lo = _sub_lora(lt, f"{pre}.mamba")
                    if adapter_idx is None:
                        y, _ = L.mamba_decode(
                            _fold_mamba(sp["mamba"], lo, lora_scale), hn, ci,
                            cfg, tp=tp)
                    else:
                        y, _ = L.mamba_decode(
                            sp["mamba"], hn, ci, cfg, lora=lo,
                            lora_scale=lora_scale, lora_idx=adapter_idx,
                            lora_kernel=lora_kernel, tp=tp)
                elif "mla" in sp:
                    y, _ = L.mla_decode_batch(
                        sp["mla"], hn, ci, cfg, pos=pos, valid=valid,
                        lora=_sub_lora(lt, f"{pre}.mla"),
                        lora_scale=lora_scale, lora_idx=adapter_idx,
                        lora_kernel=lora_kernel, tp=tp,
                        cache_axis=cache_axis, score_axis=score_axis)
                else:
                    mixer = "cross" if "cross" in sp else "attn"
                    y, _ = L.attention_decode_batch(
                        sp[mixer], hn, ci, cfg, kind=kind, pos=pos,
                        valid=valid, lora=_sub_lora(lt, f"{pre}.{mixer}"),
                        lora_scale=lora_scale, lora_idx=adapter_idx,
                        lora_kernel=lora_kernel, chunked=chunked, tp=tp,
                        cache_axis=None if mixer == "cross" else cache_axis)
            h = h + y
            if "dec_cross" in sp:
                hx = L.rms_norm(h, sp["lnx"], cfg.norm_eps)
                y, _ = L.attention_decode_batch(
                    sp["dec_cross"], hx,
                    {k: c[l] for k, c in cache[f"{pre}_dec_cross"].items()},
                    cfg, kind="cross_attn", pos=pos,
                    lora=_sub_lora(lt, f"{pre}.dec_cross"),
                    lora_scale=lora_scale, tp=tp)
                h = h + y
            if "moe" in sp or "ffn" in sp:
                with span("moe" if "moe" in sp else "ffn"):
                    h, _ = _feed_forward(cfg, sp, h, tp)
    if not logits:
        return None, cache
    with span("serve_head"):
        x = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
        if tp is not None:
            return tp.logits(x[:, 0], params).float(), cache
        if cfg.tie_embeddings:
            out = x[:, 0] @ params["embed"].T
        else:
            out = x[:, 0] @ params["unembed"]
        return out.float(), cache


__all__ = ["decode_chunk", "decode_step", "encode", "forward", "init_cache",
           "init_params", "loss_fn", "lora_specs", "torch_dtype"]
