"""mamba2-130m [ssm] — 24L d_model=768, attention-free, d_ff=0,
vocab=50280, ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]

Pure Mamba-2 stack: every layer is an SSD block (expand=2 → d_inner=1536,
head_dim=64 → 24 SSD heads), no separate FFN (d_ff=0).  Decode state is O(1)
in sequence length, so this arch runs ``long_500k``.

FediLoRA applicability (DESIGN.md §Arch-applicability): the paper targets
attention q/v projections, which do not exist here; LoRA attaches to the
SSD block's in/out projections instead — the aggregation and editing operate
on those adapters unchanged.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,        # unused (attention-free); kept for config uniformity
    num_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    pattern=("mamba",),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    dtype="bfloat16",
    source="arXiv:2405.21060 (Mamba-2), 130m config",
)

REDUCED = ModelConfig(
    name="mamba2-130m-reduced",
    family="ssm",
    num_layers=2,
    d_model=128,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    tie_embeddings=True,
    pattern=("mamba",),
    ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4, chunk_size=32),
    dtype="float32",
    source="reduced smoke variant",
)
