"""Universal model configuration covering all assigned architecture families.

The port's copy of ``repro.models.config``: the same fields, defaults and
period patterns, so a configuration means the same model in both packages.

A model is a stack of `n_layers` decoder (or encoder) layers following a
repeating *period pattern*: e.g. gemma3's 5 local + 1 global attention, or
jamba's 7 mamba + 1 attention with MoE on odd layers.  Periods make
heterogeneous stacks scannable: parameters are stacked over periods and the
pattern is unrolled inside the scan body, keeping the compiled HLO small for
80-layer models.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position inside a period."""

    kind: str = "attn"  # 'attn' | 'mamba'
    attn_pattern: str = "full"  # 'full' | 'swa' | 'chunked'
    mlp_kind: str = "swiglu"  # 'swiglu' | 'geglu' | 'gelu' | 'moe'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | audio | recsys
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention pattern knobs
    attention: str = "full"  # full | swa | local_global | chunked
    window: int = 0  # swa / local window size
    local_global_period: int = 0  # gemma3: 5 local + 1 global -> 6
    chunk_size: int = 0  # llama4 chunked attention
    rope_theta: float = 10_000.0

    # MLP / MoE
    mlp_kind: str = "swiglu"
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1  # MoE layer every `moe_period` layers
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    attn_period: int = 0  # jamba: one attn layer per `attn_period` layers

    # encoder-decoder
    enc_layers: int = 0

    # modality frontend stub
    frontend: Optional[str] = None  # 'vision' | 'audio'
    frontend_positions: int = 0  # patch/frame embeddings per sample

    # numerics / memory
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"  # 'full' | 'dots' | 'none'
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    optimizer: str = "adamw"  # 'adamw' | 'adafactor'
    # per-arch sharding-rule overrides (e.g. grok-1 has 8 experts < 16-way
    # model axis, so experts replicate and the expert FFN is TP over 'ff')
    sharding_overrides: tuple = ()  # of (logical_axis, mesh_axis|None) pairs
    # gradient-accumulation microbatches for training (0 = auto: sized so one
    # microbatch's activations fit HBM — per-device microbatch <= ~8k tokens)
    microbatches: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows padded to a 256 multiple (the reference's
        layout, divisible by a 16-way vocab sharding).  Logits beyond
        vocab_size are masked to -1e30 in the head."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    # -- layer period pattern -------------------------------------------------
    def period(self) -> tuple[LayerSpec, ...]:
        """The repeating layer pattern; len divides n_layers."""
        if self.family == "ssm":
            return (LayerSpec(kind="mamba"),)

        if self.family == "hybrid":
            # jamba: 1 attn per attn_period layers, MoE every moe_period
            p = self.attn_period or 8
            specs = []
            for i in range(p):
                kind = "attn" if i == p // 2 else "mamba"
                mlp = "moe" if (self.n_experts and i % self.moe_period == 1) else self.mlp_kind
                specs.append(LayerSpec(kind=kind, mlp_kind=mlp))
            return tuple(specs)

        # attention-pattern period
        if self.attention == "local_global" and self.local_global_period > 1:
            pat = ["swa"] * (self.local_global_period - 1) + ["full"]
        elif self.attention == "swa":
            pat = ["swa"]
        elif self.attention == "chunked":
            # iRoPE-style: 3 chunked + 1 full per period of 4
            pat = ["chunked", "chunked", "chunked", "full"]
        else:
            pat = ["full"]

        # MoE period
        if self.n_experts and self.moe_period > 1:
            mlps = ["moe" if i % self.moe_period == self.moe_period - 1 else self.mlp_kind
                    for i in range(self.moe_period)]
        elif self.n_experts:
            mlps = ["moe"]
        else:
            mlps = [self.mlp_kind]

        plen = math.lcm(len(pat), len(mlps))
        specs = tuple(
            LayerSpec(kind="attn", attn_pattern=pat[i % len(pat)], mlp_kind=mlps[i % len(mlps)])
            for i in range(plen)
        )
        return specs

    @property
    def n_periods(self) -> int:
        plen = len(self.period())
        if self.n_layers % plen:
            raise ValueError(f"{self.name}: {self.n_layers} layers do not split into periods "
                             f"of {plen}")
        return self.n_layers // plen


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'
    shard_kv_seq: bool = False  # context-parallel KV for tiny-batch decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode", shard_kv_seq=True),
}
