"""Rank programs of ``test_torch_lm_tp.py``, run by ``launch.mesh.run_spmd``
on CPU ranks over gloo.

They live apart from the test file so that a spawned rank imports only
torch and the port.  Each takes the rank's mesh first, gets its inputs as
numpy, and returns numpy or plain Python.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.distributed.sharding import shard
from repro_torch.launch.specs import auto_microbatches, make_optimizer_for, shape_rules
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeConfig
from repro_torch.models.layers import ParamTree
from repro_torch.train import Layout, Optimizer, init_state, make_train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.step import state_shardings


def tp_config(arch: str, overrides=None):
    """The reduced `arch` under its full config's sharding rule and optimizer
    (the reduced configs carry neither), with `overrides` of its fields."""
    full = get_arch(arch).config
    return dataclasses.replace(get_arch(arch).reduced, sharding_overrides=full.sharding_overrides,
                               optimizer=full.optimizer, **(overrides or {}))


def shapes(b: int, s: int, max_seq: int) -> dict:
    """The small cells of one arch: train and prefill of `b` x `s`, decode
    against caches of `max_seq` positions."""
    return {"train": ShapeConfig("tp_train", s, b, "train"),
            "prefill": ShapeConfig("tp_prefill", s, b, "prefill"),
            "decode": ShapeConfig("tp_decode", max_seq, b, "decode")}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy() if t.dtype == torch.bfloat16 else \
        t.detach().numpy().copy()


def _tree_np(tree) -> dict:
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v) for k, v in tree.items()}


def _recording(opt: Optimizer, seen: dict) -> Optimizer:
    def update(grads, state, params, sq_sum=None, **kw):
        seen.update({k: _np(g) for k, g in grads.items()})
        return opt.update(grads, state, params, sq_sum, **kw)

    return Optimizer(opt.init, update)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


def arch_case(mesh, arch: str, tree, batch: dict, prompts, steps: int, max_seq: int,
              frames=None, ckpt=None, overrides=None) -> dict:
    """One arch on this rank: its parameter blocks, one train step of its
    rows (loss, averaged gradients, updated blocks and optimizer state;
    saved in the global format under `ckpt` where it is given), prefill
    (the enc-dec's encode) under the prefill rules with the collectives it
    made, and `steps` greedy decode steps under the decode rules from the
    prefill's caches, resharded, with each step's collectives.  The train
    step's collectives (calls and bytes by kind) are kept too.
    `overrides` change the config's fields (``tp_config``)."""
    cfg = tp_config(arch, overrides)
    mod = E if cfg.is_encdec else T
    b, s = prompts.shape[0], prompts.shape[1]
    cells = shapes(b, batch["tokens"].shape[1], max_seq)
    rules = shape_rules(cfg, cells["train"], mesh)
    whole = mod.params_from_numpy(tree, cfg, "cpu")
    out = {"params": _tree_np(_rank_params(whole, cfg, rules))}

    model = ParamTree(_rank_params(whole, cfg, rules))
    specs = _flat(mod.param_pspecs(cfg, rules))
    seen: dict = {}
    opt = _recording(make_optimizer_for(cfg), seen)
    state = init_state(model, opt, layout=Layout(mesh, specs))
    step = make_train_step(lambda m, bt: mod.loss_fn(m.tree(), bt, cfg, rules), opt,
                           microbatches=auto_microbatches(cfg, cells["train"], mesh),
                           rules=rules, param_specs=specs)
    batch_rows = rules.pspec("batch")
    local = {k: shard(torch.from_numpy(v), mesh, (*batch_rows,) + (None,) * (v.ndim - 1))
             for k, v in batch.items()}
    mesh.counter.reset()
    state, metrics = step(state, local)
    out["train"] = {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": seen,
                    "params": {k: _np(p) for k, p in model.named_parameters()},
                    "opt": _tree_np(state["opt"]),
                    "calls": dict(mesh.counter.calls), "bytes": dict(mesh.counter.bytes)}
    if ckpt is not None:
        whole_meta = {k: torch.empty(v.shape, device="meta") for k, v in _flat(whole).items()}
        CheckpointManager(ckpt, async_save=False).save(
            1, state, mesh=mesh, specs=state_shardings(opt, whole_meta, specs))

    prules, drules = (shape_rules(cfg, cells[k], mesh) for k in ("prefill", "decode"))
    params = _rank_params(whole, cfg, prules)
    rows = shard(torch.from_numpy(prompts), mesh, (*prules.pspec("batch"), None))
    mesh.counter.reset()
    if cfg.is_encdec:
        enc = E.encode(params, shard(torch.from_numpy(frames), mesh,
                                     (*prules.pspec("batch"), None, None)), cfg, prules)
        out["prefill"] = _np(enc)
        out["prefill_calls"] = dict(mesh.counter.calls)
        caches = E.cross_caches(params, enc, cfg, max_seq, prules)
        tok, start = rows[:, :1], 0
    else:
        logits, caches = T.prefill(params, rows, cfg, prules, max_seq)
        out["prefill_calls"] = dict(mesh.counter.calls)
        logits = T.gather_logits(logits, prules)
        out["prefill"] = _np(logits)
        tok, start = _greedy(logits), s
    out["prefill_caches"] = _tree_np(caches)
    caches = T.reshard_caches(caches, cfg, prules, drules, pspec_fn=mod.cache_pspecs)
    out["decode_caches_before"] = _tree_np(caches)
    dparams = _rank_params(whole, cfg, drules)
    out["decode"], out["decode_comm"] = [], []
    for i in range(steps):
        mesh.counter.reset()
        logits, caches = mod.decode_step(dparams, tok, caches, start + i, cfg, drules, mesh=mesh)
        out["decode_comm"].append((dict(mesh.counter.calls), dict(mesh.counter.bytes)))
        logits = T.gather_logits(logits, drules)
        out["decode"].append(_np(logits))
        tok = _greedy(logits)
    return out


def _flat(tree, path: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{path}.{k}" if path else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _rank_params(whole, cfg, rules):
    """This rank's blocks of `whole` under the model's ``param_pspecs``."""
    mod = E if cfg.is_encdec else T
    specs = mod.param_pspecs(cfg, rules)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return shard(node, rules.mesh, spec).clone()

    return walk(whole, specs)


def tp_rank(mesh, cases: dict) -> dict:
    """Every arch case of this world, by arch."""
    return {arch: arch_case(mesh, **c) for arch, c in cases.items()}
