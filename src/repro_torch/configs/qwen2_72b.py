"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA with QKV bias. [arXiv:2407.10671]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    dtype="bfloat16",
    source="arXiv:2407.10671 (Qwen2), 72B config",
)

REDUCED = ModelConfig(
    name="qwen2-72b-reduced",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    qkv_bias=True,
    tie_embeddings=True,
    dtype="float32",
    source="reduced smoke variant",
)
