"""Unified model configuration covering all assigned architecture families.

One dataclass describes dense / MoE / SSM / hybrid / VLM / enc-dec stacks.
Layer heterogeneity (gemma3's 5 local : 1 global attention, jamba's 1 attn :
7 mamba interleave, llama-3.2-vision's cross-attention every 5th layer) is
expressed as a repeating *block pattern*: ``num_layers`` must be a multiple of
``len(pattern)`` and the model scans over ``num_layers // len(pattern)``
stacked blocks, applying the pattern's sublayers in a static inner loop.
Compile time therefore scales with the pattern length, not the depth.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

LayerKind = Literal["attn", "attn_local", "mamba", "cross_attn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int | None = None       # defaults to d_ff_expert
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_dtype: str = "float32"
    # which layers (index within the full depth) are MoE; period 1 = all
    layer_period: int = 1
    layer_offset: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0                 # 0 = dense q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "encdec"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # defaults to d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # --- attention pattern -------------------------------------------------
    # pattern of sublayer kinds repeated through the depth; default all attn.
    pattern: tuple = ("attn",)
    sliding_window: int = 0              # for "attn_local" layers
    attn_logit_softcap: float = 0.0

    # --- mixtures ----------------------------------------------------------
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None

    # --- multimodal frontends (stubbed — see DESIGN.md §4) ------------------
    vision_dim: int = 0                  # vlm: dim of incoming patch embeds
    num_vision_tokens: int = 0
    vision_mode: Literal["cross", "prefix"] = "cross"  # llama-3.2-v vs LLaVA-style
    audio_dim: int = 0                   # encdec: dim of incoming frame embeds
    encoder_layers: int = 0              # encdec: encoder depth

    # --- provenance ---------------------------------------------------------
    source: str = ""                     # citation for the configuration

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not a multiple of "
                f"pattern length {len(self.pattern)}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_blocks(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def period(self) -> int:
        return len(self.pattern)

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return layer_idx % self.moe.layer_period == self.moe.layer_offset

    @property
    def supports_long_decode(self) -> bool:
        """True if every layer's decode state is o(seq_len) or the arch is
        explicitly approved for long-context decode in DESIGN.md §4."""
        kinds = set(self.pattern)
        if kinds <= {"mamba"}:
            return True
        if "mamba" in kinds:               # hybrid: attn cache only on 1/period layers
            return True
        if "attn_local" in kinds:          # sliding-window dense (gemma3)
            return True
        return False

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            kind = self.pattern[i % self.period]
            if kind in ("attn", "attn_local"):
                if self.mla is not None:
                    m = self.mla
                    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                    if m.q_lora_rank:
                        n += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qd
                    else:
                        n += d * self.num_heads * qd
                    n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    n += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    n += self.num_heads * m.v_head_dim * d
                else:
                    n += d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            elif kind == "cross_attn":
                n += d * hd * self.num_heads * 2 + self.vision_dim * hd * self.num_kv_heads * 2
            elif kind == "mamba":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                n += d * (2 * d_in + 2 * s.state_dim + d_in // s.head_dim) + d_in * d
            # feed-forward
            if self.is_moe_layer(i):
                mo = self.moe
                n_ff = mo.num_experts * 3 * d * mo.d_ff_expert
                n_ff += mo.num_shared_experts * 3 * d * (mo.d_ff_shared or mo.d_ff_expert)
                n_ff += d * mo.num_experts  # router
                n += n_ff
            elif kind != "mamba":  # mamba blocks have no separate FFN here
                n += 3 * d * self.d_ff
        if self.encoder_layers:
            n += self.encoder_layers * (d * hd * (self.num_heads + 2 * self.num_kv_heads)
                                        + self.num_heads * hd * d + 3 * d * self.d_ff)
        return n

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: only routed-in experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        mo = self.moe
        n_moe_layers = sum(1 for i in range(self.num_layers) if self.is_moe_layer(i))
        all_expert = n_moe_layers * mo.num_experts * 3 * self.d_model * mo.d_ff_expert
        act_expert = n_moe_layers * mo.experts_per_token * 3 * self.d_model * mo.d_ff_expert
        return full - all_expert + act_expert
