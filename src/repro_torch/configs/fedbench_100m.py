"""fedbench-100m — paper-proxy LLaVA-style prefix VLM (~100M params) used by
the end-to-end federated fine-tuning example (examples/federated_finetune.py).

Stands in for LLaVA-1.5-7B, which cannot be fetched in this container: same
topology (decoder LM consuming projected image-patch prefix embeddings, LoRA
on attention q/v), scaled to train a few hundred steps on CPU.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="fedbench-100m",
    family="vlm",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=3072,
    vocab_size=256,        # synthetic task vocab
    tie_embeddings=True,
    vision_dim=32,         # synthetic patch-embedding dim
    num_vision_tokens=8,
    vision_mode="prefix",
    dtype="float32",
    source="paper-proxy bench model (LLaVA-1.5 stand-in, DESIGN.md §1)",
)

REDUCED = ModelConfig(
    name="fedbench-100m-reduced",
    family="vlm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=256,
    tie_embeddings=True,
    vision_dim=32,
    num_vision_tokens=8,
    vision_mode="prefix",
    dtype="float32",
    source="reduced smoke variant",
)
