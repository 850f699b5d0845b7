"""Per-(arch x shape) specs: the sharding rules of a shape, the stand-ins of
every model input, the gradient-accumulation depth, the optimizer and model
module of an arch, and the lowering cells that ``launch.dryrun`` reads.
The port of ``repro.launch.specs``.

The reference's ``jax.ShapeDtypeStruct`` is ``common.util.ShapeDtype`` here:
a (shape, dtype) record with no storage.  Its ``PartitionSpec``s are the
port's spec tuples (``distributed.sharding``), its ``NamedSharding`` the
port's record of a mesh and a spec.

A cell (``LoweringSpec``, built by ``build_train_cell``,
``build_prefill_cell``, ``build_decode_cell`` or ``build_cell``) is one
rank's program: ``fn`` is the function the rank runs (the meshed train
step, ``prefill``, ``decode_step``, or the enc-dec ``encode``), ``args``
its inputs as ``ShapeDtype`` trees of the rank's blocks, and
``in_shardings`` the spec trees they are blocks of, as ``NamedSharding``
records (None with no mesh).  Nothing is allocated: the mesh may be a
record built without a world (``launch.mesh.Mesh(shape, rank,
torch.device("meta"), "none")``), which answers for any rank.  A train
cell's state holds the parameters as a nested tree where the step takes a
``models.layers.ParamTree`` of them, and the optimizer state in the
reference's layout (``train.step.opt_state_pspecs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.util import ShapeDtype
from repro_torch.distributed.sharding import NamedSharding, ShardingRules, block_shape
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.layers import shapes_from_schema
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.step import make_train_step, opt_state_pspecs


@dataclasses.dataclass
class LoweringSpec:
    name: str
    fn: Callable
    args: tuple  # trees of ShapeDtype: the rank's blocks
    in_shardings: Any  # trees of NamedSharding (None without a mesh)
    rules: ShardingRules


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


def _record(node):
    """A tree of tensors (meta or not) as a tree of ``ShapeDtype``."""
    if isinstance(node, dict):
        return {k: _record(v) for k, v in node.items()}
    return ShapeDtype(tuple(node.shape), node.dtype)


def params_struct_and_specs(cfg: ModelConfig, rules: ShardingRules):
    """The global ``ShapeDtype`` tree of the parameters (``cfg.param_dtype``)
    and its spec tree under `rules`."""
    mod = _model_module(cfg)
    struct = _record(shapes_from_schema(mod.model_schema(cfg), getattr(torch, cfg.param_dtype)))
    return struct, mod.param_pspecs(cfg, rules)


def _blocks(struct, specs, mesh):
    """The rank's blocks of a global ``ShapeDtype`` tree under a spec tree
    (the tree itself without a mesh)."""
    if mesh is None:
        return struct
    if isinstance(struct, dict):
        return {k: _blocks(v, specs[k], mesh) for k, v in struct.items()}
    return ShapeDtype(block_shape(struct.shape, mesh, specs), struct.dtype)


def _shard(mesh, spec_tree):
    if mesh is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: _shard(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, spec_tree)


def _flat(tree, path: str = "") -> dict:
    """A nested dict flattened to ``layers.ParamTree``'s dotted names."""
    out = {}
    for k, v in tree.items():
        name = f"{path}.{k}" if path else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


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

    return {
        "token": ShapeDtype((shape.global_batch, 1), torch.int32),
        "caches": _record(mod.cache_spec(cfg, shape.global_batch, shape.seq_len)),
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



# ---------------------------------------------------------------------------
# Lowering builders


def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> LoweringSpec:
    """One rank's train step of `cfg` at `shape`: the state (parameters,
    optimizer state, step) and the rank's rows of the batch."""
    rules = shape_rules(cfg, shape, mesh)
    mod = _model_module(cfg)
    optimizer = make_optimizer_for(cfg)
    pstruct, pspecs = params_struct_and_specs(cfg, rules)
    flat_specs = _flat(pspecs)
    whole = _flat(pstruct)
    ostate = optimizer.init(whole)
    ospecs = opt_state_pspecs(optimizer, whole, flat_specs)
    step = make_train_step(
        lambda m, b: mod.loss_fn(m.tree(), b, cfg, rules), optimizer,
        microbatches=auto_microbatches(cfg, shape, mesh),
        rules=rules if mesh is not None else None,
        param_specs=flat_specs if mesh is not None else None,
    )
    state_struct = {"params": pstruct, "opt": ostate, "step": ShapeDtype((), torch.int32)}
    state_specs = {"params": pspecs, "opt": ospecs, "step": ()}
    batch_struct = train_batch_struct(cfg, shape)
    batch_specs = train_batch_pspecs(cfg, shape, rules)
    return LoweringSpec(
        name=f"{cfg.name}:{shape.name}",
        fn=step,
        args=(_blocks(state_struct, state_specs, mesh), _blocks(batch_struct, batch_specs, mesh)),
        in_shardings=(_shard(mesh, state_specs), _shard(mesh, batch_specs)),
        rules=rules,
    )


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> LoweringSpec:
    """One rank's prefill (the enc-dec's encode) of its rows."""
    rules = shape_rules(cfg, shape, mesh)
    pstruct, pspecs = params_struct_and_specs(cfg, rules)
    b, s = shape.global_batch, shape.seq_len
    batch = rules.pspec("batch")
    if cfg.is_encdec:
        # prefill for enc-dec = encode the source (cross-KV derive happens in
        # the decode cell; encoding dominates prefill cost)
        fn = lambda params, frames: encdec.encode(params, frames, cfg, rules)  # noqa: E731
        x, x_spec = ShapeDtype((b, s, cfg.d_model), getattr(torch, cfg.dtype)), (*batch, None, None)
    else:
        fn = lambda params, tokens: tfm.prefill(params, tokens, cfg, rules, s)  # noqa: E731
        x, x_spec = ShapeDtype((b, s), torch.int32), (*batch, None)
    args = (_blocks(pstruct, pspecs, mesh), _blocks(x, x_spec, mesh))
    return LoweringSpec(f"{cfg.name}:{shape.name}", fn, args,
                        (_shard(mesh, pspecs), _shard(mesh, x_spec)), rules)


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> LoweringSpec:
    """One rank's decode step: its rows' token, its blocks of the caches,
    the length."""
    rules = shape_rules(cfg, shape, mesh)
    mod = _model_module(cfg)
    pstruct, pspecs = params_struct_and_specs(cfg, rules)
    b, s = shape.global_batch, shape.seq_len
    cache_struct = _record(mod.cache_spec(cfg, b, s))
    cache_specs = mod.cache_pspecs(cfg, rules)
    tok_spec = (*rules.pspec("batch"), None)

    def fn(params, token, caches, n):
        return mod.decode_step(params, token, caches, n, cfg, rules, mesh=mesh,
                               shard_kv_seq=shape.shard_kv_seq)

    args = (_blocks(pstruct, pspecs, mesh),
            _blocks(ShapeDtype((b, 1), torch.int32), tok_spec, mesh),
            _blocks(cache_struct, cache_specs, mesh), ShapeDtype((), torch.int32))
    in_sh = (_shard(mesh, pspecs), _shard(mesh, tok_spec), _shard(mesh, cache_specs),
             _shard(mesh, ()))
    return LoweringSpec(f"{cfg.name}:{shape.name}", fn, args, in_sh, rules)


def build_cell(cfg: ModelConfig, shape_name: str, mesh) -> LoweringSpec:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh)
    return build_decode_cell(cfg, shape, mesh)
