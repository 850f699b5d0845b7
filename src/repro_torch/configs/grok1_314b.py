"""grok-1-314b [moe] — 8 experts top-2, every layer MoE.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2
[hf:xai-org/grok-1; unverified].  Pure full attention -> long_500k SKIPPED.
bf16 params + Adafactor, as the reference sizes it for its TPU pod.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    attention="full",
    mlp_kind="swiglu",
    n_experts=8,
    top_k=2,
    moe_period=1,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    optimizer="adafactor",
    # 8 experts divide neither the 16-way model nor data axes: each expert
    # is TP over 'ff' and the expert axis replicates (the reference's choice)
    sharding_overrides=(("experts", None), ("ff", "model")),
)

REDUCED = ModelConfig(
    name="grok-1-314b-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attention="full",
    mlp_kind="swiglu",
    n_experts=4,
    top_k=2,
    moe_period=1,
    dtype="float32",
    param_dtype="float32",
    remat="none",
)

SKIP_SHAPES = frozenset({"long_500k"})
