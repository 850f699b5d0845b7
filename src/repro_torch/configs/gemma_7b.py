"""gemma-7b [dense] — GeGLU, head_dim=256, full (global) attention.

28L d_model=3072 16H (GQA kv=16 = MHA) d_ff=24576 vocab=256000
[arXiv:2403.08295; hf].  Pure full attention -> long_500k SKIPPED
(see DESIGN.md §Arch-applicability).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    attention="full",
    mlp_kind="geglu",
    rope_theta=10_000.0,
    optimizer="adamw",
    remat="dots",
)

REDUCED = ModelConfig(
    name="gemma-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    attention="full",
    mlp_kind="geglu",
    dtype="float32",
    remat="none",
)

SKIP_SHAPES = frozenset({"long_500k"})  # pure full attention
