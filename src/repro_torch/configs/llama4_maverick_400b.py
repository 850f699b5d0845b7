"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, interleaved MoE,
iRoPE-style chunked attention.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-* pattern; unverified].  Chunked attention (8k
chunks, 3 chunked + 1 full per period) keeps long-context tractable ->
long_500k RUNS.  MoE every other layer (interleaved, Maverick-style).
bf16 params + Adafactor (400B total, 17B active).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    attention="chunked",
    chunk_size=8192,
    mlp_kind="swiglu",
    n_experts=128,
    top_k=1,
    moe_period=2,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    optimizer="adafactor",
    # EP over data (128 experts / 16 = 8 per shard) + TP over model within
    # each expert (the reference's choice)
    sharding_overrides=(("experts", "data"), ("ff", "model")),
)

REDUCED = ModelConfig(
    name="llama4-maverick-smoke",
    family="moe",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    attention="chunked",
    chunk_size=32,
    mlp_kind="swiglu",
    n_experts=8,
    top_k=1,
    moe_period=2,
    dtype="float32",
    param_dtype="float32",
    remat="none",
)

SKIP_SHAPES: frozenset = frozenset()  # chunked attention => long_500k runs
