"""Per-(arch x shape) specs: the sharding rules of a shape, the stand-ins of
every model input, the gradient-accumulation depth, and the optimizer and
model module of an arch, as ``launch.train --mode lm`` builds them.  The
port of ``repro.launch.specs``.

The reference's ``jax.ShapeDtypeStruct`` is ``common.util.ShapeDtype`` here:
a (shape, dtype) record with no storage.  Its ``PartitionSpec``s are the
port's spec tuples (``distributed.sharding``).  The reference's lowering
cells (``LoweringSpec``, ``build_*_cell``, the sharded state trees the dry
run lowers) describe the reference's GSPMD layout, tensor parallelism over
``model`` and FSDP over ``data``, which the port does not run: they wait
for that layout (ROADMAP A8).
"""

from __future__ import annotations

import torch

from repro_torch.common.util import ShapeDtype
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.train import optimizer as opt_lib


def shape_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> ShardingRules:
    """The arch's rules for one shape: context-parallel decode (batch whole,
    the cache's sequence over ``data``) where the shape asks for it; the
    cache's sequence over ``model`` for the other decode shapes (GQA kv-head
    counts do not divide the model axis)."""
    overrides = dict(cfg.sharding_overrides)
    if shape.kind == "decode" and shape.shard_kv_seq:
        overrides.update({"batch": None, "kv_seq": "data"})
    elif shape.kind == "decode":
        overrides.setdefault("kv_seq", "model")
    return ShardingRules.make(mesh, overrides)


def make_optimizer_for(cfg: ModelConfig):
    """``cfg.optimizer`` (adamw or adafactor) over the reference's schedule:
    warmup-cosine to 3e-4, 100 warmup steps, 10,000 in all."""
    lr = opt_lib.warmup_cosine(3e-4, 100, 10_000)
    return opt_lib.make_optimizer(cfg.optimizer, lr)


def _model_module(cfg: ModelConfig):
    return encdec if cfg.is_encdec else tfm


# ---------------------------------------------------------------------------
# input specs per family x shape


def train_batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    i32, f32 = torch.int32, torch.float32
    if cfg.is_encdec:
        return {
            "frames": ShapeDtype((b, s, cfg.d_model), dt),
            "tokens": ShapeDtype((b, s), i32),
            "labels": ShapeDtype((b, s), i32),
            "mask": ShapeDtype((b, s), f32),
        }
    if cfg.family == "vlm" and cfg.frontend_positions:
        p = cfg.frontend_positions
        return {
            "tokens": ShapeDtype((b, s - p), i32),
            "labels": ShapeDtype((b, s - p), i32),
            "mask": ShapeDtype((b, s - p), f32),
            "prefix_embeds": ShapeDtype((b, p, cfg.d_model), dt),
        }
    return {
        "tokens": ShapeDtype((b, s), i32),
        "labels": ShapeDtype((b, s), i32),
        "mask": ShapeDtype((b, s), f32),
    }


def train_batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules) -> dict:
    batch = rules.pspec("batch")
    b2 = (*batch, None)
    b3 = (*batch, None, None)
    if cfg.is_encdec:
        return {"frames": b3, "tokens": b2, "labels": b2, "mask": b2}
    if cfg.family == "vlm" and cfg.frontend_positions:
        return {"tokens": b2, "labels": b2, "mask": b2, "prefix_embeds": b3}
    return {"tokens": b2, "labels": b2, "mask": b2}


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """``ShapeDtype`` stand-ins for every model input of one cell."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_batch_struct(cfg, shape)
    mod = _model_module(cfg)
    if shape.kind == "prefill":
        if cfg.is_encdec:
            return {"frames": ShapeDtype((shape.global_batch, shape.seq_len, cfg.d_model),
                                         getattr(torch, cfg.dtype))}
        return {"tokens": ShapeDtype((shape.global_batch, shape.seq_len), torch.int32)}

    def record(node):
        if isinstance(node, dict):
            return {k: record(v) for k, v in node.items()}
        return ShapeDtype(tuple(node.shape), node.dtype)

    return {
        "token": ShapeDtype((shape.global_batch, 1), torch.int32),
        "caches": record(mod.cache_spec(cfg, shape.global_batch, shape.seq_len)),
        "cache_len": ShapeDtype((), torch.int32),
    }


def auto_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Gradient-accumulation depth so one microbatch's activations fit a
    card, from the mesh's shape alone: the layer stack keeps the residual
    (B_rank, S, d_model) per layer for the backward, ~4·B_rank·S·d·layers
    bytes, held to 4 GiB, the reference's operating point."""
    if cfg.microbatches:
        return cfg.microbatches
    if mesh is None:
        return 1
    batch_shards = 1
    for ax in ("pod", "data"):
        if ax in mesh.shape:
            batch_shards *= mesh.shape[ax]
    per_dev_batch = max(shape.global_batch // batch_shards, 1)
    carry_bytes_per_tok = 4.0 * cfg.d_model * max(cfg.n_layers, 1)
    budget = 4 * 2**30
    target_tokens = max(int(budget / carry_bytes_per_tok), 1024)
    k = 1
    while (
        per_dev_batch * shape.seq_len / k > target_tokens
        and k < per_dev_batch
        and shape.global_batch % (k * 2) == 0
    ):
        k *= 2
    return k

