"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-1b-pt pattern; unverified].  Local window 1024; period of
6 = 5 SWA + 1 global.  long_500k RUNS: 40 of 48 layers are windowed; the 8
global layers hold the full KV but decode is O(S) per token.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    attention="local_global",
    local_global_period=6,
    window=1024,
    mlp_kind="geglu",
    rope_theta=10_000.0,
    optimizer="adamw",
    remat="dots",
)

REDUCED = ModelConfig(
    name="gemma3-12b-smoke",
    family="dense",
    n_layers=6,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    attention="local_global",
    local_global_period=6,
    window=32,
    mlp_kind="geglu",
    dtype="float32",
    remat="none",
)

SKIP_SHAPES: frozenset = frozenset()  # mostly-local => long_500k runs
