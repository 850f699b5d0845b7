"""mamba2-1.3b [ssm] — pure SSD (state-space duality), attention-free.

48L d_model=2048 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified].  d_inner=4096, head_dim=64 -> 64 SSD heads.
O(1) state per token -> long_500k RUNS (this is the showcase arch for it).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_chunk=128,
    optimizer="adamw",
    remat="dots",
)

REDUCED = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=32,
    dtype="float32",
    remat="none",
)

SKIP_SHAPES: frozenset = frozenset()
