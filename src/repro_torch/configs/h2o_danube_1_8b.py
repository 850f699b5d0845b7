"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818; hf]
SWA window 4096 (mistral-style), so long_500k RUNS (sub-quadratic).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attention="swa",
    window=4096,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
    optimizer="adamw",
    remat="dots",
)

REDUCED = ModelConfig(
    name="h2o-danube-1.8b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attention="swa",
    window=64,
    mlp_kind="swiglu",
    dtype="float32",
    remat="none",
)

SKIP_SHAPES: frozenset = frozenset()  # SWA => long_500k runs
