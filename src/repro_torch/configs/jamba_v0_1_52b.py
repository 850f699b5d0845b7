"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536 [arXiv:2403.19887; hf].
Period of 8: one attention layer per 8 (position 4), the rest mamba;
MoE every other layer.  SSM state 16 (jamba uses mamba-1 state size; we run
the SSD formulation with N=16 — recorded in DESIGN.md).  long_500k RUNS:
only 4 of 32 layers hold full KV.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    mlp_kind="swiglu",
    n_experts=16,
    top_k=2,
    moe_period=2,
    attn_period=8,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_chunk=256,
    rope_theta=10_000.0,
    optimizer="adafactor",
)

REDUCED = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    mlp_kind="swiglu",
    n_experts=4,
    top_k=2,
    moe_period=2,
    attn_period=8,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=32,
    dtype="float32",
    remat="none",
)

SKIP_SHAPES: frozenset = frozenset()  # hybrid => long_500k runs
