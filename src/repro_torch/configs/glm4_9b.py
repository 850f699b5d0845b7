"""glm4-9b [dense] — RoPE, extreme GQA (kv=2).

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552
[hf:THUDM/glm-4-9b].  Pure full attention -> long_500k SKIPPED.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    attention="full",
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    optimizer="adamw",
    remat="dots",
)

REDUCED = ModelConfig(
    name="glm4-9b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attention="full",
    mlp_kind="swiglu",
    dtype="float32",
    remat="none",
)

SKIP_SHAPES = frozenset({"long_500k"})
