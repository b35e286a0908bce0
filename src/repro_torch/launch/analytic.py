"""Analytic roofline cost model (port of ``repro/launch/analytic.py``).

The reference's closed-form model of one rank's work, copied term for
term: FLOPs, HBM bytes, collective bytes and ``detail`` are the
reference's bit for bit (the tests hold them equal over every arch, shape,
mesh and option).  Only the seconds differ, because the constants are the
H100's (``repro_torch.launch.roofline``): the collective term runs at
``LINK_BW``, the inter-node network the production meshes' axes cross.

The model mirrors the reference's *implementation*, not an ideal
algorithm, and assumes the reference's placement:

* attention is charged for the full S×S_kv score block the chunked path
  computes (causal masking skips no work unless ``causal_skip``);
* MoE is charged at capacity (E·C tokens, C = k·T/E·cf);
* training costs 3× the forward matmuls (activation gradients + the
  remat recompute; only the adapters take weight gradients);
* collectives follow the reference's sharding: Megatron-TP activation
  all-reduces per layer, FSDP weight all-gathers over ``"data"`` per
  microbatch, the data-parallel LoRA-gradient all-reduce per step.

The port's own program places weights otherwise (no FSDP; a sublayer
whose heads do not divide ``"model"`` stays whole): its measured terms
come from the dry run's trace (``repro_torch.launch.dryrun``,
``roofline_traced``), beside these.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.launch.specs import InputShape
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    chips: int
    dp: int      # batch-sharding ways (pod × data)
    tp: int      # tensor-parallel ways (model)
    fsdp: int    # weight-sharding ways over data axis


def mesh_info(multi_pod: bool) -> MeshInfo:
    return MeshInfo(chips=512 if multi_pod else 256,
                    dp=32 if multi_pod else 16, tp=16, fsdp=16)


_BYTES = {"bfloat16": 2, "float32": 4}


def _layer_kinds(cfg: ModelConfig):
    for i in range(cfg.num_layers):
        yield i, cfg.pattern[i % cfg.period]


def _attn_dims(cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        return m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    return hd, hd


def matmul_params_per_layer(cfg: ModelConfig, kind: str, moe_at_capacity: bool,
                            layer_idx: int) -> float:
    """Matmul parameters touched per token for one layer (MoE at routed
    activation; capacity factor applied separately in flops)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    n = 0.0
    if kind in ("attn", "attn_local"):
        if cfg.mla is not None:
            m = cfg.mla
            qd = m.qk_nope_head_dim + m.qk_rope_head_dim
            n += (d * m.q_lora_rank + m.q_lora_rank * h * qd) if m.q_lora_rank else d * h * qd
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
            n += h * m.v_head_dim * d
        else:
            n += d * hd * (h + 2 * kv) + h * hd * d
    elif kind == "cross_attn":
        n += d * h * hd + cfg.vision_dim * kv * hd * 2 + h * hd * d
    elif kind == "mamba":
        s = cfg.ssm
        d_in = s.expand * d
        n += d * (2 * d_in + 2 * s.state_dim + d_in // s.head_dim) + d_in * d
    if cfg.is_moe_layer(layer_idx):
        mo = cfg.moe
        cf = mo.capacity_factor if moe_at_capacity else 1.0
        n += mo.experts_per_token * cf * 3 * d * mo.d_ff_expert
        n += mo.num_shared_experts * 3 * d * (mo.d_ff_shared or mo.d_ff_expert)
        n += d * mo.num_experts
    elif kind != "mamba" and cfg.d_ff > 0:
        n += 3 * d * cfg.d_ff
    return n


def _attn_score_flops_per_token(cfg: ModelConfig, kind: str, s_kv: float) -> float:
    qd, vd = _attn_dims(cfg)
    h = cfg.num_heads
    return 2.0 * s_kv * h * (qd + vd)


def _mamba_flops_per_token(cfg: ModelConfig) -> float:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H, P, N, Q = d_in // s.head_dim, s.head_dim, s.state_dim, s.chunk_size
    # intra-chunk: CB^T (2QN) + M·dt·x (2Q·H·P); states + y_inter: 4·N·H·P
    return 2.0 * Q * N + 2.0 * Q * H * P + 4.0 * N * H * P


def _lora_matmul_params(cfg: ModelConfig, rank: int) -> float:
    from repro_torch.models.transformer import lora_specs
    return float(sum(s.num_layers * rank * (s.in_dim + s.out_dim)
                     for s in lora_specs(cfg)))


def _param_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * _BYTES.get(cfg.dtype, 2)


def _cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    b = _BYTES.get(cfg.dtype, 2)
    total = 0.0
    for _, kind in _layer_kinds(cfg):
        if kind in ("attn", "attn_local"):
            if cfg.mla is not None:
                m = cfg.mla
                total += batch * seq * (m.kv_lora_rank + m.qk_rope_head_dim) * b
            else:
                s = min(seq, cfg.sliding_window) if (kind == "attn_local" and
                                                     cfg.sliding_window) else seq
                total += 2 * batch * s * cfg.num_kv_heads * cfg.resolved_head_dim * b
        elif kind == "mamba":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            total += batch * (d_in // s.head_dim) * s.head_dim * s.state_dim * 4
            total += batch * (s.conv_width - 1) * (d_in + 2 * s.state_dim) * b
        elif kind == "cross_attn":
            total += 2 * batch * cfg.num_vision_tokens * cfg.num_kv_heads \
                * cfg.resolved_head_dim * b
    return total


@dataclasses.dataclass
class AnalyticTerms:
    flops_dev: float
    hbm_bytes_dev: float
    coll_bytes_dev: float
    detail: dict

    def roofline(self) -> dict:
        c = self.flops_dev / PEAK_FLOPS
        m = self.hbm_bytes_dev / HBM_BW
        k = self.coll_bytes_dev / LINK_BW
        dom = max({"compute": c, "memory": m, "collective": k}.items(),
                  key=lambda kv: kv[1])[0]
        return {"compute_s": c, "memory_s": m, "collective_s": k, "dominant": dom,
                "flops_per_device": self.flops_dev,
                "hbm_bytes_per_device": self.hbm_bytes_dev,
                "collective_bytes_per_device": self.coll_bytes_dev,
                **self.detail}


def analytic_terms(cfg: ModelConfig, shape: InputShape, mi: MeshInfo, *,
                   rank: int = 32, num_micro: int | None = None,
                   opts: dict | None = None) -> AnalyticTerms:
    """Compute per-device roofline terms.  ``opts`` carries hillclimb toggles:
    ``window_skip`` (flash skips fully-masked chunks), ``causal_skip``
    (causal triangle skipped), ``expert_parallel`` (MoE all-to-all instead of
    dense TP), ``no_fsdp_regather_bwd`` etc."""
    opts = opts or {}
    bts = _BYTES.get(cfg.dtype, 2)
    d = cfg.d_model
    B, S = shape.global_batch, shape.seq_len
    dp_eff = min(mi.dp, B) if B else 1
    kind = shape.kind

    if kind in ("train", "prefill"):
        tokens_dev = B * S / dp_eff
        if num_micro is None:
            num_micro = max(B // mi.dp, 1) if kind == "train" else 1
    else:
        tokens_dev = max(B / dp_eff, 1.0)
        num_micro = 1

    # ---- FLOPs -------------------------------------------------------------
    mm = 0.0
    attn_extra = 0.0
    n_attn_layers = 0
    for i, k_ in _layer_kinds(cfg):
        mm += matmul_params_per_layer(cfg, k_, True, i)
        if k_ in ("attn", "attn_local"):
            n_attn_layers += 1
            if kind == "decode":
                s_kv = min(S, cfg.sliding_window) if (k_ == "attn_local" and
                                                      cfg.sliding_window) else S
                if cfg.mla is not None:
                    m = cfg.mla
                    attn_extra += 2.0 * s_kv * cfg.num_heads * (
                        2 * m.kv_lora_rank + m.qk_rope_head_dim)
                    attn_extra += 2.0 * cfg.num_heads * m.kv_lora_rank * (
                        m.qk_nope_head_dim + m.v_head_dim)
                else:
                    attn_extra += _attn_score_flops_per_token(cfg, k_, s_kv)
            else:
                s_kv = S
                if k_ == "attn_local" and cfg.sliding_window:
                    # flash window-skip is default behaviour (§Perf): only
                    # chunks intersecting the window are computed
                    s_kv = min(S, cfg.sliding_window + 1024)
                elif opts.get("causal_skip"):
                    s_kv = S / 2
                attn_extra += _attn_score_flops_per_token(cfg, k_, s_kv)
        elif k_ == "cross_attn":
            attn_extra += _attn_score_flops_per_token(cfg, "attn", cfg.num_vision_tokens)
        elif k_ == "mamba" and kind != "decode":
            attn_extra += _mamba_flops_per_token(cfg)
        elif k_ == "mamba":
            s = cfg.ssm
            d_in = s.expand * d
            attn_extra += 6.0 * (d_in // s.head_dim) * s.head_dim * s.state_dim
    if cfg.family == "encdec" and kind != "decode":
        enc_tokens_ratio = 0.25   # frames = S/4
        mm += cfg.encoder_layers * (d * cfg.resolved_head_dim *
                                    (cfg.num_heads + 2 * cfg.num_kv_heads)
                                    + cfg.num_heads * cfg.resolved_head_dim * d
                                    + 3 * d * cfg.d_ff) * enc_tokens_ratio

    mm += _lora_matmul_params(cfg, rank)
    # unembed (tied or not): full-seq for train, last-only for prefill/decode
    unembed = d * cfg.vocab_size
    fwd_flops_per_token = 2.0 * (mm) + attn_extra
    if kind == "train":
        flops_dev = tokens_dev * (3.0 * fwd_flops_per_token + 2.0 * unembed * 3.0)
    elif kind == "prefill":
        flops_dev = tokens_dev * fwd_flops_per_token + 2.0 * unembed * B / dp_eff
    else:
        flops_dev = tokens_dev * (fwd_flops_per_token + 2.0 * unembed)
    flops_dev /= mi.tp  # matmul work is tensor-parallel over "model"

    # ---- HBM bytes ---------------------------------------------------------
    # expert-parallel: expert weights are fully 2D-sharded (no gather) —
    # split param bytes into the EP-exempt expert portion and the rest.
    expert_bytes = 0.0
    if cfg.moe is not None and opts.get("expert_parallel"):
        mo = cfg.moe
        n_moe = sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
        expert_bytes = n_moe * mo.num_experts * 3 * cfg.d_model \
            * mo.d_ff_expert * _BYTES.get(cfg.dtype, 2)
    gatherable = _param_bytes(cfg) - expert_bytes
    wb_dev = gatherable / (mi.tp * mi.fsdp) + expert_bytes / (mi.tp * mi.fsdp)
    wb_full_tp = gatherable / mi.tp + expert_bytes / (mi.tp * mi.fsdp)
    act_coeff = 14.0                                  # rw of block intermediates
    act_bytes = act_coeff * tokens_dev * d * bts * cfg.num_layers
    if kind == "train":
        # fwd + remat recompute + bwd each stream the (gathered) weights once
        hbm = 3.0 * num_micro * wb_full_tp + 3.0 * act_bytes
    elif kind == "prefill":
        hbm = wb_full_tp + act_bytes
    else:
        cache_dev = _cache_bytes(cfg, B, S) / mi.chips
        hbm = wb_full_tp + cache_dev + 4.0 * tokens_dev * d * bts * cfg.num_layers

    # ---- collective bytes ---------------------------------------------------
    coll = 0.0
    act_layer = tokens_dev * d * bts
    # Megatron-TP: 2 all-reduces per layer (attn out, ffn out); all-reduce
    # moves ~2×(p-1)/p ≈ 2× payload per device.  Sequence-parallel converts
    # each into a 1/tp-payload reduce-scatter + all-gather pair around the
    # pointwise region, plus one full-activation all-gather at the attention
    # boundary (Megatron-SP accounting).
    tp_factor = 2.0 * (mi.tp - 1) / mi.tp
    passes = 3.0 if kind == "train" else 1.0
    if opts.get("seq_parallel") and kind == "train":
        per_layer = 2 * act_layer * 2.0 / mi.tp + act_layer  # RS+AG + attn AG
        coll += passes * cfg.num_layers * per_layer * (mi.tp - 1) / mi.tp
    else:
        coll += passes * cfg.num_layers * 2 * act_layer * tp_factor
    # FSDP weight all-gather per microbatch (fwd + recompute + bwd ≈ 2 gathers)
    gathers = 2.0 * num_micro if kind == "train" else 1.0
    ag_factor = (mi.fsdp - 1) / mi.fsdp
    coll += gathers * (gatherable / mi.tp) * ag_factor
    # expert-parallel token movement: all-to-all of routed activations
    if cfg.moe is not None and opts.get("expert_parallel"):
        mo = cfg.moe
        n_moe = sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
        coll += passes * n_moe * 2 * tokens_dev * mo.experts_per_token * d * bts
    # DP gradient all-reduce of LoRA adapters (per step, train only)
    if kind == "train":
        lora_bytes = _lora_matmul_params(cfg, rank) * 4
        coll += 2.0 * lora_bytes * (mi.dp - 1) / mi.dp
    if kind == "decode" and B < mi.dp:
        # seq-sharded cache: per-step distributed softmax all-reduce (small)
        coll += n_attn_layers * cfg.num_heads * 4 * 2

    detail = {
        "tokens_per_device": tokens_dev, "num_microbatches": num_micro,
        "weight_bytes_per_device": wb_dev, "fwd_flops_per_token": fwd_flops_per_token,
        "model_flops": 6.0 * cfg.active_param_count() * B * S if kind == "train"
        else 2.0 * cfg.active_param_count() * (B * S if kind == "prefill" else B),
    }
    return AnalyticTerms(flops_dev, hbm, coll, detail)
