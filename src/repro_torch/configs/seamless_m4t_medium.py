"""seamless-m4t-medium [audio] — encoder-decoder, multimodal frontend STUB.

12L (decoder) + 12L (encoder) d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 [arXiv:2308.11596; hf].  input_specs() provides precomputed
audio frame embeddings for the encoder (modality frontend is a stub per the
assignment).  Full-attention enc-dec -> long_500k SKIPPED; decode shapes run
(it has a decoder).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    attention="full",
    mlp_kind="gelu",
    rope_theta=10_000.0,
    frontend="audio",
    optimizer="adamw",
    remat="dots",
)

REDUCED = ModelConfig(
    name="seamless-smoke",
    family="audio",
    n_layers=2,
    enc_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    attention="full",
    mlp_kind="gelu",
    frontend="audio",
    dtype="float32",
    remat="none",
)

SKIP_SHAPES = frozenset({"long_500k"})
