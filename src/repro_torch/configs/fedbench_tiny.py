"""fedbench-tiny — 4-layer prefix-VLM for fast CPU federated benchmarks
(the per-paper-table benchmark harness runs many federated rounds × three
aggregation methods; this scale keeps a full Table-1 sweep tractable)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="fedbench-tiny",
    family="vlm",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=352,
    vocab_size=256,
    tie_embeddings=True,
    vision_dim=32,
    num_vision_tokens=8,
    vision_mode="prefix",
    dtype="float32",
    source="paper-proxy bench model (tiny)",
)

REDUCED = CONFIG
