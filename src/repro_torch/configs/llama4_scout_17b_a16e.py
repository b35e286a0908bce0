"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Every layer is MoE (interleave step 1 in Scout) with top-1 routing plus an
always-on shared expert, per the model card.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    tie_embeddings=False,
    rope_theta=500_000.0,
    moe=MoEConfig(
        num_experts=16,
        experts_per_token=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        d_ff_shared=8192,
    ),
    dtype="bfloat16",
    source="hf:meta-llama/Llama-4-Scout-17B-16E model card",
)

REDUCED = ModelConfig(
    name="llama4-scout-reduced",
    family="moe",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=4, experts_per_token=1, d_ff_expert=512,
                  num_shared_experts=1, d_ff_shared=512),
    dtype="float32",
    source="reduced smoke variant",
)
