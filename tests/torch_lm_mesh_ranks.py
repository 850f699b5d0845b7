"""Rank programs of ``test_torch_lm_mesh.py`` (and of the meshed cases of
``test_torch_lm_ssm_moe.py``), run by ``launch.mesh.run_spmd`` on CPU ranks
over gloo.

They live apart from the test files so that a spawned rank imports only
torch and the port.  Each takes the rank's mesh first, gets its inputs as
numpy, and returns numpy or plain Python.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import ShardingRules, shard
from repro_torch.launch.specs import shape_rules
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.layers import ParamTree, cp_decode_attention
from repro_torch.train import Layout, init_state, make_optimizer, make_train_step

LR = 1e-3  # the one update's constant learning rate
MOE_RULE_ARCH = "llama4-maverick-400b-a17b"  # whose full config's expert rule the MoE cases take


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().copy()


def _tree_np(tree) -> dict:
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v) for k, v in tree.items()}


def a2a_case(mesh, xs, gs, split: int, concat: int) -> dict:
    """``comm.all_to_all`` of this rank's `xs[rank]`, and the gradient of
    <y, gs[rank]> summed over the ranks, with the bytes and calls of each."""
    x = torch.from_numpy(xs[mesh.rank].copy()).requires_grad_(True)
    mesh.counter.reset()
    y = comm.all_to_all(x, mesh, "data", split, concat)
    fwd = mesh.counter.bytes["all-to-all"]
    y.backward(torch.from_numpy(gs[mesh.rank].copy()))
    return {"y": _np(y), "grad": _np(x.grad), "fwd_bytes": fwd,
            "bytes": mesh.counter.bytes["all-to-all"], "calls": mesh.counter.calls["all-to-all"]}


def cp_attention_case(mesh, q, k, v, clen, kw: dict) -> np.ndarray:
    """``cp_decode_attention`` over this rank's slice of the global k, v."""
    spec = (None, "data", None, None)
    return _np(cp_decode_attention(
        torch.from_numpy(q), shard(torch.from_numpy(k), mesh, spec).clone(),
        shard(torch.from_numpy(v), mesh, spec).clone(), torch.from_numpy(clen), mesh=mesh,
        **kw))


def cp_decode_case(mesh, arch: str, tree, caches, token, start: int, steps: int) -> dict:
    """`steps` greedy context-parallel decode steps of the reduced `arch`
    under ``long_500k``'s rules from the one-device prefill `caches`
    (sliced here): each step's logits, bytes and calls, the tokens, this
    rank's caches after, and C11 at the global length."""
    cfg = get_arch(arch).reduced
    rules = shape_rules(cfg, SHAPES["long_500k"], mesh)
    params = T.rank_params(T.params_from_numpy(tree, cfg, "cpu"), cfg, rules)
    specs = T.cache_pspecs(cfg, rules)
    local = {name: {k: shard(torch.from_numpy(a), mesh, specs[name][k]).clone()
                    for k, a in c.items()} for name, c in caches.items()}
    tok = torch.from_numpy(token)
    out = {"logits": [], "tokens": [], "bytes": [], "calls": []}
    for i in range(steps):
        mesh.counter.reset()
        logits, local = T.decode_step(params, tok, local, start + i, cfg, rules, mesh=mesh,
                                      shard_kv_seq=True)
        out["bytes"].append(dict(mesh.counter.bytes))
        out["calls"].append(dict(mesh.counter.calls))
        out["logits"].append(_np(logits))
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        out["tokens"].append(_np(tok))
    out["caches"] = _tree_np(local)
    kept = {name: {k: t.clone() for k, t in c.items()} for name, c in local.items()}
    s_local = next(c["k"].shape[2] for c in local.values() if "k" in c)
    try:
        T.decode_step(params, tok, local, mesh.shape["data"] * s_local, cfg, rules, mesh=mesh,
                      shard_kv_seq=True)
        out["c11"] = None
    except ValueError as e:
        out["c11"] = str(e)
    out["c11_untouched"] = all(torch.equal(local[n][k], kept[n][k]) for n in local
                               for k in local[n])
    out["s_local"] = s_local
    return out


def moe_rules(mesh) -> ShardingRules:
    """llama4's expert rule (experts over ``data``) on `mesh`."""
    return ShardingRules.make(mesh, dict(get_arch(MOE_RULE_ARCH).config.sharding_overrides))


def moe_case(mesh, tree, prompts, steps: int, batch: dict, x) -> dict:
    """The reduced llama4 under its expert rule: prefill and `steps` greedy
    decode steps of this rank's rows, one MoE layer on `x`'s rows with its
    all-to-all bytes, and one meshed AdamW train step on `batch`'s rows
    (its metrics, averaged gradients and updated parameters)."""
    cfg = get_arch(MOE_RULE_ARCH).reduced
    rules = moe_rules(mesh)
    whole = T.params_from_numpy(tree, cfg, "cpu")
    params = T.rank_params(whole, cfg, rules)
    rows = shard(torch.from_numpy(prompts), mesh, rules.pspec("batch", None))
    p = rows.shape[1]
    out = {"logits": []}
    logits, caches = T.prefill(params, rows, cfg, rules, p + steps + 1)
    out["prefill"] = _np(logits)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    for i in range(steps):
        logits, caches = T.decode_step(params, tok, caches, p + i, cfg, rules, mesh=mesh)
        out["logits"].append(_np(logits))
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]

    layer = T._period(params["layers"], 0)["p1"]["mlp"]  # the second layer: a MoE
    xr = shard(torch.from_numpy(x), mesh, rules.pspec("batch", None, None))
    mesh.counter.reset()
    y, aux = M.moe_apply(layer, xr, cfg, rules)
    out["moe"] = {"y": _np(y), "aux": float(aux), "bytes": dict(mesh.counter.bytes),
                  "calls": dict(mesh.counter.calls)}

    model = ParamTree(T.rank_params(T.params_from_numpy(tree, cfg, "cpu"), cfg, rules))
    opt = make_optimizer("adamw", lambda step: torch.full((), LR))
    specs = T.flat_rank_param_pspecs(cfg, rules)
    state = init_state(model, opt, layout=Layout(mesh, specs))
    step = make_train_step(lambda m, b: T.loss_fn(m.tree(), b, cfg, rules), opt, rules=rules,
                           param_specs=specs)
    local = {k: shard(torch.from_numpy(v), mesh, rules.pspec("batch", None))
             for k, v in batch.items()}
    mesh.counter.reset()
    _, metrics = step(state, local)
    out["train"] = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {k: _np(p.grad) for k, p in model.named_parameters()},
        "params": {k: _np(p) for k, p in model.named_parameters()},
        "a2a_calls": mesh.counter.calls["all-to-all"],
    }
    return out


def lm_mesh_rank(mesh, cases: dict) -> dict:
    """Every case of a (data=2, model=1) world, by name."""
    out = {"a2a": [a2a_case(mesh, *c) for c in cases["a2a"]],
           "cp_attention": [cp_attention_case(mesh, *c) for c in cases["cp_attention"]]}
    for name, c in cases["cp_decode"].items():
        out[name] = cp_decode_case(mesh, **c)
    out["moe"] = moe_case(mesh, **cases["moe"])
    return out


def cp_attention_rank(mesh, cases: list) -> list:
    """``cp_decode_attention`` of each case over this (data, model) rank."""
    return [cp_attention_case(mesh, *c) for c in cases]


def moe_layer_case(mesh, cfg_fields: dict, tree, x) -> dict:
    """``moe_apply`` of a `cfg_fields` config with experts over ``data``, on
    this rank's rows of `x`, the experts' weights whole (the layer takes
    the rank's block): its output, aux and all-to-all bytes and calls."""
    cfg = ModelConfig(**cfg_fields)
    rules = ShardingRules.make(mesh, {"experts": "data"})
    params = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    xr = shard(torch.from_numpy(x), mesh, rules.pspec("batch", None, None))
    y, aux = M.moe_apply(params, xr, cfg, rules)
    return {"y": _np(y), "aux": float(aux), "bytes": mesh.counter.bytes["all-to-all"],
            "calls": mesh.counter.calls["all-to-all"]}


def ssm_moe_rank(mesh, moe_args: dict, cp_args: dict) -> dict:
    """The meshed cases of ``test_torch_lm_ssm_moe.py``: one MoE layer by
    all-to-all and one context-parallel decode step of the reduced jamba."""
    return {"moe": moe_layer_case(mesh, **moe_args), "cp": cp_decode_case(mesh, **cp_args)}
