"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, gated cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision]

The vision tower is a stub per the assignment carve-out: ``input_specs()``
supplies post-projector patch embeddings [B, 1600, 4096]; the cross-attention
layers (tanh-gated, 8 of 40) consume them.  LoRA attaches to self- AND
cross-attention q/v.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    tie_embeddings=False,
    rope_theta=500_000.0,
    pattern=("attn", "attn", "attn", "attn", "cross_attn"),
    vision_dim=4096,
    num_vision_tokens=1600,
    vision_mode="cross",
    dtype="bfloat16",
    source="hf:meta-llama/Llama-3.2-11B-Vision model card",
)

REDUCED = ModelConfig(
    name="llama-3.2-vision-reduced",
    family="vlm",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    tie_embeddings=True,
    pattern=("attn", "cross_attn"),
    vision_dim=64,
    num_vision_tokens=16,
    vision_mode="cross",
    dtype="float32",
    source="reduced smoke variant",
)
