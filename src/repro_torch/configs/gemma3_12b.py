"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt family; dims per assignment]

The 5:1 interleave is one pattern block of 5 sliding-window layers followed
by one global layer; 48 layers = 8 scanned blocks.  Because of the sliding
window, this arch runs ``long_500k`` (local KV caches are bounded at the
window; global layers hold the full cache, O(S) per decoded token) — see
DESIGN.md §4.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=("attn_local",) * 5 + ("attn",),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    source="hf:google/gemma-3 family (assigned dims); 5:1 local:global per Gemma 3 report",
)

REDUCED = ModelConfig(
    name="gemma3-12b-reduced",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    pattern=("attn_local", "attn"),
    sliding_window=16,
    tie_embeddings=True,
    dtype="float32",
    source="reduced smoke variant",
)
