"""Shared helpers of the LM parity tests (``tests/test_torch_lm_*.py``):
the port and ``repro.models`` run from the same numpy weights (the
reference's ``init_params`` carried across by ``params_from_numpy``) and
the same seeded prompts, in f32 within ``TOL`` unless a test says
otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.distributed.sharding import ShardingRules as JRules
from repro.models import transformer as JT
from repro.train import make_serve_step as j_make_serve_step
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models import transformer as T
from repro_torch.train import make_serve_step

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
