"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attention 7:1 interleave, MoE 16 experts top-2 every
other layer. [arXiv:2403.19887]

One pattern block = 8 layers: attention at in-block index 4, Mamba elsewhere
(Jamba's l=8, a=1); MoE replaces the MLP on every second layer (e=2, offset
1).  32 layers = 4 scanned blocks.  Decode state: full KV cache only on the
4 attention layers; O(1) SSD state elsewhere → runs ``long_500k``.

Note: Jamba v0.1 uses Mamba-1 blocks; we instantiate Mamba-2 (SSD) blocks —
the TPU-native matmul-dominant formulation (DESIGN.md §3 hardware adaptation).
"""

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    tie_embeddings=False,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    moe=MoEConfig(num_experts=16, experts_per_token=2, d_ff_expert=14336,
                  layer_period=2, layer_offset=1),
    dtype="bfloat16",
    source="arXiv:2403.19887 (Jamba), l=8 a=1 e=2 16-expert top-2",
)

REDUCED = ModelConfig(
    name="jamba-reduced",
    family="hybrid",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    tie_embeddings=True,
    pattern=("mamba", "attn"),
    ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4, chunk_size=32),
    moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=256,
                  layer_period=2, layer_offset=1),
    dtype="float32",
    source="reduced smoke variant",
)
