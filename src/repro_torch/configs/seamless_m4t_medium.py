"""seamless-m4t-medium [audio] — enc-dec, 12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206, multimodal. [arXiv:2308.11596]

Transformer backbone only (assignment carve-out): the mel-spectrogram +
conv feature extractor is a stub — ``input_specs()`` provides precomputed
audio frame embeddings [B, S/4, 1024] consumed by a 12-layer bidirectional
encoder; the 12-layer decoder self-attends causally and cross-attends to the
encoder output.  LoRA attaches to encoder self-attn q/v and decoder self- &
cross-attn q/v.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,          # decoder depth
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    tie_embeddings=True,
    audio_dim=1024,
    dtype="bfloat16",
    source="arXiv:2308.11596 (SeamlessM4T medium)",
)

REDUCED = ModelConfig(
    name="seamless-m4t-reduced",
    family="encdec",
    num_layers=2,
    encoder_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    tie_embeddings=True,
    audio_dim=64,
    dtype="float32",
    source="reduced smoke variant",
)
