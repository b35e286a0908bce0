"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 — llama-like; trained with the WSD schedule. [arXiv:2404.06395]

The WSD (warmup-stable-decay) schedule is implemented in
``repro.optim.schedules.wsd_schedule`` and selected by this arch's training
recipe (see ``repro/launch/train.py --schedule wsd``).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    dtype="bfloat16",
    source="arXiv:2404.06395 (MiniCPM)",
)

REDUCED = ModelConfig(
    name="minicpm-2b-reduced",
    family="dense",
    num_layers=2,
    d_model=288,
    num_heads=4,
    num_kv_heads=4,
    head_dim=72,
    d_ff=512,
    vocab_size=512,
    tie_embeddings=True,
    dtype="float32",
    source="reduced smoke variant",
)
