"""Shared helpers of the LM parity tests (``tests/test_torch_lm_*.py``):
the port and ``repro.models`` run from the same numpy weights (the
reference's ``init_params`` carried across by ``params_from_numpy``) and
the same seeded prompts, in f32 within ``TOL`` unless a test says
otherwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as JR
from repro.distributed.sharding import ShardingRules as JRules
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro.train import make_serve_step as j_make_serve_step
from repro.train import optimizer as JO
from repro.train.step import apply_updates as j_apply_updates
from repro_torch.configs import registry as PR
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.train import make_serve_step
from repro_torch.train import optimizer as O

TOL = dict(rtol=1e-5, atol=1e-5)
J_RULES = JRules.make(None)
RULES = ShardingRules.make(None)
B, PROMPT, DECODE = 2, 96, 4  # the prompt passes h2o's reduced window (64)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)), **(tol or TOL))


def run_both(jcfg, cfg, *, prompt=PROMPT, decode=DECODE, seed=0):
    """The reference's and the port's prefill and greedy decode from the
    same numpy weights and prompts: logits, caches and tokens of each."""
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(seed), jcfg))
    params = T.params_from_numpy(tree, cfg, "cpu")
    toks = np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, prompt)).astype(np.int32)
    max_seq = prompt + decode

    jl, jc = jax.jit(lambda p, x: JT.prefill(p, x, jcfg, J_RULES, max_seq))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))
    jserve = jax.jit(j_make_serve_step(
        lambda p, x, c, n: JT.decode_step(p, x, c, n, jcfg, J_RULES)))
    ref = {"prefill": np.asarray(jl, np.float32), "caches": jax.tree.map(np.asarray, jc),
           "logits": [], "tokens": []}
    jtok = jnp.argmax(jl[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    jp = jax.tree.map(jnp.asarray, tree)
    for i in range(decode):
        jtok, lg, jc = jserve(jp, jtok, jc, jnp.int32(prompt + i))
        ref["logits"].append(np.asarray(lg, np.float32))
        ref["tokens"].append(np.asarray(jtok))
    ref["caches_after"] = jax.tree.map(np.asarray, jc)
    ref["tree"] = tree

    pl, pc = T.prefill(params, t(toks), cfg, RULES, max_seq)
    port = {"prefill": pl, "caches": jax.tree.map(lambda x: x.clone(), pc), "logits": [],
            "tokens": []}
    pserve = make_serve_step(lambda p, x, c, n: T.decode_step(p, x, c, n, cfg, RULES))
    ptok = torch.argmax(pl[:, -1, :], dim=-1).to(torch.int32)[:, None]
    for i in range(decode):
        ptok, lg, pc = pserve(params, ptok, pc, prompt + i)
        port["logits"].append(lg)
        port["tokens"].append(ptok.numpy())
    port["caches_after"] = pc
    port["params"] = params
    port["prompts"] = toks
    return ref, port


def assert_trees_close(got, want, **tol) -> None:
    """Every leaf of a tree of tensors against the reference's numpy tree:
    the same paths and shapes, values within `tol` (``TOL`` by default)."""
    g = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda x: x.numpy(), got))[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, gv), (_, wv) in zip(g, w):
        assert gv.shape == wv.shape, path
        np.testing.assert_allclose(gv, wv, err_msg=str(path), **(tol or TOL))


def assert_runs_match(ref, port) -> None:
    """Prefill logits, the caches after prefill and after decode, every
    decode step's logits within ``TOL``; the greedy tokens equal."""
    assert tuple(port["prefill"].shape) == ref["prefill"].shape
    close(port["prefill"], ref["prefill"])
    assert_trees_close(port["caches"], ref["caches"])
    for got, want in zip(port["logits"], ref["logits"]):
        close(got, want)
    assert np.array_equal(np.concatenate(port["tokens"], 1), np.concatenate(ref["tokens"], 1))
    assert_trees_close(port["caches_after"], ref["caches_after"])


# -- training (tests/test_torch_lm_train*.py) ---------------------------------

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def nested(named) -> dict:
    """(dotted name, tensor) pairs as the reference's nested dict of numpy
    arrays."""
    out: dict = {}
    for name, v in named:
        *groups, leaf = name.split(".")
        d = out
        for g in groups:
            d = d.setdefault(g, {})
        d[leaf] = v.detach().float().numpy() if isinstance(v, torch.Tensor) else v
    return out


def lm_batch(cfg, seq: int, batch: int = B, *, seed: int = 0, segments: bool = False,
             prefix: bool = False) -> dict:
    """A seeded numpy batch (``TokenSynthesizer``'s tokens, labels and mask
    as f32; its segment ids when `segments`), with numpy frames (enc-dec)
    or prefix embeddings (`prefix`)."""
    from repro_torch.data.tokens import TokenSynthesizer

    raw = TokenSynthesizer(cfg.vocab_size, seq, seed=seed).shard_batch(0, 0, batch)
    out = {"tokens": raw["tokens"], "labels": raw["labels"],
           "mask": raw["mask"].astype(np.float32)}
    if segments:
        out["segment_ids"] = raw["segment_ids"]
    rng = np.random.default_rng(seed + 100)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    if prefix:
        out["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    return out


def ref_value_and_grad(jmod, jcfg, tree, batch):
    """The reference's (loss, metrics, grads) of `jmod.loss_fn` as numpy."""
    fn = jax.jit(jax.value_and_grad(lambda p, b: jmod.loss_fn(p, b, jcfg, J_RULES),
                                    has_aux=True))
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, tree),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def port_value_and_grad(mod, cfg, tree, batch):
    """The port's (loss, metrics, grads by dotted name, model) of
    `mod.loss_fn` over a ``ParamTree`` of the same numpy tree, on the CPU."""
    from repro_torch.models.layers import ParamTree

    model = ParamTree(mod.params_from_numpy(tree, cfg, "cpu"))
    loss, metrics = mod.loss_fn(model.tree(), {k: t(v) for k, v in batch.items()}, cfg, RULES)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(loss.detach()), {k: float(v) for k, v in metrics.items()}, grads, model


PARAM_TOL = dict(rtol=0, atol=1e-5)


def both_configs(arch):
    return JR.get_arch(arch).reduced, PR.get_arch(arch).reduced


def init_tree(jmod, jcfg, seed=0):
    return jax.tree.map(np.asarray, jmod.init_params(jax.random.PRNGKey(seed), jcfg))


def assert_grads_close(got: dict, want, **tol):
    g = jax.tree_util.tree_flatten_with_path(nested(got.items()))[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, gv), (_, wv) in zip(g, w):
        assert np.isfinite(gv).all(), path
        np.testing.assert_allclose(gv, wv, err_msg=str(path), **(tol or GRAD_TOL))


def check_loss(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], err_msg=k, **TOL)


def flat(tree, prefix=""):
    """A nested numpy tree as tensors by dotted name."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, name) if isinstance(v, dict) else {name: t(v)})
    return out


def one_update(name, tree, jgrads, model):
    """The reference's and the port's parameters after one update of
    optimizer `name` from the same (the reference's) gradients: AdamW's
    first step is g / (|g| + eps), which the gradients' own tolerance would
    move by more than 1e-5 where a gradient entry is near eps."""
    lr = JO.warmup_cosine(1e-3, 2, 100)
    jopt = JO.make_optimizer(name, lr)
    jp = jax.tree.map(jnp.asarray, tree)

    @jax.jit
    def step(g, p):
        upd, _, m = jopt.update(g, jopt.init(p), p)
        return j_apply_updates(p, upd), m

    new, jm = step(jax.tree.map(jnp.asarray, jgrads), jp)
    want = jax.tree.map(np.asarray, new)
    popt = O.make_optimizer(name, O.warmup_cosine(1e-3, 2, 100))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = flat(jgrads)
    _, pm = popt.update(grads, popt.init(params), params)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    return nested(params.items()), want


def check_arch(arch: str, seq: int) -> None:
    """An arch's reduced config in both packages from the reference's
    weights: loss, metrics and every gradient leaf, then one AdamW and one
    Adafactor update from the reference's gradients."""
    jcfg, cfg = both_configs(arch)
    jmod, mod = (JE, E) if cfg.is_encdec else (JT, T)
    tree = init_tree(jmod, jcfg)
    batch = lm_batch(cfg, seq, prefix=cfg.family == "vlm" and cfg.frontend_positions > 0)
    ref = ref_value_and_grad(jmod, jcfg, tree, batch)
    got = port_value_and_grad(mod, cfg, tree, batch)
    check_loss(got, ref)
    if cfg.n_experts:
        assert got[1]["moe_aux"] > 0
    assert_grads_close(got[2], ref[2])
    for name in ("adamw", "adafactor"):
        params, want = one_update(name, tree, ref[2], got[3])
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **PARAM_TOL), params, want)


def check_remat_modes(arch: str, seq: int) -> None:
    """Remat "none", "dots" and "full" give the same loss and gradients,
    bitwise on the CPU."""
    jcfg, cfg = both_configs(arch)
    jmod, mod = (JE, E) if cfg.is_encdec else (JT, T)
    tree = init_tree(jmod, jcfg)
    batch = lm_batch(cfg, seq)
    runs = {remat: port_value_and_grad(mod, dataclasses.replace(cfg, remat=remat), tree, batch)
            for remat in ("none", "dots", "full")}
    for remat in ("dots", "full"):
        assert runs[remat][0] == runs["none"][0]
        for n, g in runs["none"][2].items():
            assert torch.equal(runs[remat][2][n], g), (remat, n)
