"""deepseek-v2-236b [moe] — 60L d_model=5120 128H, MLA kv_lora=512,
MoE 160 routed experts top-6 + 2 shared, expert d_ff=1536, vocab=102400.
[arXiv:2405.04434]

Multi-head Latent Attention: KV compressed to a 512-dim latent (+64-dim
shared RoPE key); decode uses the absorbed-weight path over the *compressed*
cache (repro.models.layers.mla_decode).  q_lora_rank=1536 per the paper.

Note: DeepSeek-V2's first layer is dense-FFN; we instantiate all 60 layers
as MoE (uniform scan block) — a <0.5% parameter deviation recorded here and
in DESIGN.md.
"""

from repro_torch.models.config import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,     # MLA: heads share the compressed latent
    d_ff=12288,           # (dense-layer width; unused — all layers MoE here)
    vocab_size=102400,
    tie_embeddings=False,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, experts_per_token=6, d_ff_expert=1536,
                  num_shared_experts=2, d_ff_shared=1536),
    dtype="bfloat16",
    source="arXiv:2405.04434 (DeepSeek-V2)",
)

REDUCED = ModelConfig(
    name="deepseek-v2-reduced",
    family="moe",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=512,
    tie_embeddings=True,
    mla=MLAConfig(kv_lora_rank=64, q_lora_rank=48,
                  qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
    moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=256,
                  num_shared_experts=1, d_ff_shared=256),
    dtype="float32",
    source="reduced smoke variant",
)
