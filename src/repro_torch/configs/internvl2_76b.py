"""internvl2-76b [vlm] — InternViT frontend (STUB) + InternLM2-76B backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 [arXiv:2404.16821].
The vision tower is a stub per the assignment: input_specs() provides 256
precomputed patch embeddings per sample, prepended to the token sequence.
Pure full attention -> long_500k SKIPPED.  Adafactor (76B params).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    attention="full",
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    frontend="vision",
    frontend_positions=256,
    optimizer="adafactor",
)

REDUCED = ModelConfig(
    name="internvl2-76b-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attention="full",
    mlp_kind="swiglu",
    frontend="vision",
    frontend_positions=16,
    dtype="float32",
    remat="none",
)

SKIP_SHAPES = frozenset({"long_500k"})
