"""The meshed LM of the port on CPU ranks over gloo, against the JAX
package's meshed LM on fake devices (one ``conftest.run_sharded`` script)
and against the port's one-device LM.

Two worlds of ``launch.mesh.run_spmd`` (rank programs in
``torch_lm_mesh_ranks.py``): (4, 2) for the reference's own
context-parallel attention case, (data=2, model=1) for the rest.  f32
throughout, rtol=atol=1e-5 unless a test says otherwise: the partial
softmaxes combine and the sums run in another order on each side.

* ``comm.all_to_all``: bitwise a numpy exchange, forward and backward;
  its bytes a rank equal the reference's compiled MoE layer's
  (``hlo_cost.analyze``, max(operand, result));
* ``cp_decode_attention`` (full, swa, chunked) against the reference's and
  the port's plain ``decode_attention``;
* the reduced h2o-danube and jamba decoding context-parallel under
  ``long_500k``'s rules: every step's logits against the reference's
  meshed decode and the port's one-device decode, the greedy tokens equal,
  the ranks' logits bitwise equal, the writes at ``s_local - 1`` (rank 0)
  and ``s_local`` (rank 1), C11 at the global length with the caches
  untouched, one ``pmax`` and two ``psum``s an attention layer;
* ``cache_pspecs`` of both models: the reference's, every arch, on single-
  and multi-pod mesh shapes;
* the reduced llama4 under llama4's expert rule (experts over ``data``):
  prefill and decode logits, one MoE layer and its aux, the loss and every
  gradient against the reference's meshed run; against the port's one
  device: the logits and the layer (routing is per batch row, so both drop
  the same choices), the aux against the mean of each rank's rows' aux
  (the reference's ``pmean``), and one meshed AdamW step against the
  one-device step over 2 microbatches of the ranks' rows, which is the
  same function.
"""

import pickle
import types

import jax
import numpy as np
import pytest
import torch

import torch_lm_mesh_ranks as R
from conftest import run_sharded
from repro.configs import registry as JR
from repro.distributed.sharding import ShardingRules as JRules
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro_torch.configs import registry as PR
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import run_spmd
from repro_torch.models import encdec as E
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamTree, decode_attention
from repro_torch.train import make_optimizer, make_train_step

TOL = dict(rtol=1e-5, atol=1e-5)
CP_ARCHS = {"h2o": "h2o-danube-1.8b", "jamba": "jamba-v0.1-52b"}
S_LOCAL = 64  # a rank's slice of the cache (2 ranks)
CP_START, CP_STEPS = S_LOCAL - 1, 4  # the first step writes rank 0's last slot
MOE_B, MOE_P, MOE_STEPS, MOE_S = 4, 32, 2, 64
PATTERNS = {"full": {}, "swa": {"pattern": "swa", "window": 40},
            "chunked": {"pattern": "chunked", "chunk": 48}}


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, **tol) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **(tol or TOL))


def cp_attention_inputs(seed: int, b=1, s=256, k=2, g=4, d=16, clen=100):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, k * g, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, k, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, k, d)).astype(np.float32)
    return q, kc, vc, np.full((b,), clen, np.int32)


def numpy_tree(cfg, seed=0) -> dict:
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(seed), cfg))


def _one_device_decode(cfg, tree, prompts, start, steps):
    """The port's one-device prefill of `prompts` into a cache of 2 slices,
    and `steps` greedy decode steps: the caches before decode (numpy), the
    first token, and each step's logits, tokens and the caches after."""
    params = T.params_from_numpy(tree, cfg, "cpu")
    rules = S.ShardingRules.make(None)
    logits, caches = T.prefill(params, t(prompts), cfg, rules, 2 * S_LOCAL)
    before = jax.tree.map(lambda x: x.numpy().copy(), caches)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    first = tok.numpy().copy()
    out = {"logits": [], "tokens": []}
    for i in range(steps):
        lg, caches = T.decode_step(params, tok, caches, start + i, cfg, rules)
        out["logits"].append(lg.numpy())
        tok = torch.argmax(lg[:, -1, :], dim=-1).to(torch.int32)[:, None]
        out["tokens"].append(tok.numpy())
    out["caches"] = jax.tree.map(lambda x: x.numpy(), caches)
    return before, first, out


@pytest.fixture(scope="module")
def inputs():
    cp_decode, local = {}, {}
    for name, arch in CP_ARCHS.items():
        cfg = PR.get_arch(arch).reduced
        tree = numpy_tree(JR.get_arch(arch).reduced)
        prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, CP_START)).astype(
            np.int32)
        before, first, out = _one_device_decode(cfg, tree, prompts, CP_START, CP_STEPS)
        cp_decode[name] = dict(arch=arch, tree=tree, caches=before, token=first,
                               start=CP_START, steps=CP_STEPS)
        local[name] = dict(out, prompts=prompts)
    moe_cfg = JR.get_arch(R.MOE_RULE_ARCH).reduced
    rng = np.random.default_rng(2)
    toks = rng.integers(1, moe_cfg.vocab_size, (MOE_B, MOE_S + 1)).astype(np.int32)
    moe = dict(tree=numpy_tree(moe_cfg),
               prompts=rng.integers(1, moe_cfg.vocab_size, (MOE_B, MOE_P)).astype(np.int32),
               steps=MOE_STEPS,
               batch={"tokens": toks[:, :-1], "labels": toks[:, 1:],
                      "mask": np.ones((MOE_B, MOE_S), np.float32)},
               x=rng.normal(size=(MOE_B, MOE_S, moe_cfg.d_model)).astype(np.float32))
    a2a = []
    for split, concat, shape in ((1, 0, (2, 4, 3)), (0, 1, (4, 2, 3)), (2, 2, (3, 2, 6))):
        out = list(shape)
        out[split] //= 2
        out[concat] *= 2
        a2a.append((rng.normal(size=(2, *shape)).astype(np.float32),
                    rng.normal(size=(2, *out)).astype(np.float32), split, concat))
    cp2 = [(*cp_attention_inputs(3, s=128, clen=90), kw) for kw in PATTERNS.values()]
    cp8 = [(*cp_attention_inputs(0), kw) for kw in PATTERNS.values()]
    return {"cases": {"a2a": a2a, "cp_attention": cp2, "cp_decode": cp_decode, "moe": moe},
            "cp8": cp8, "local": local}


@pytest.fixture(scope="module")
def world(inputs):
    return run_spmd(R.lm_mesh_rank, (2, 1), ("data", "model"), device="cpu",
                    args=(inputs["cases"],), timeout=600)


@pytest.fixture(scope="module")
def world8(inputs):
    return run_spmd(R.cp_attention_rank, (4, 2), ("data", "model"), device="cpu",
                    args=(inputs["cp8"],), timeout=600)


_REF = """
import pickle, numpy as np, jax, jax.numpy as jnp
from repro.configs import registry as JR
from repro.distributed.sharding import ShardingRules
from repro.launch.hlo_cost import analyze
from repro.launch.mesh import make_mesh
from repro.launch.specs import shape_rules
from repro.models import moe as JM, transformer as JT
from repro.models.config import SHAPES
from repro.models.layers import cp_decode_attention
inp = pickle.load(open(%(path)r, "rb"))
res = {}
mesh8 = make_mesh((4, 2), ("data", "model"))
res["cp8"] = [np.asarray(jax.jit(lambda q, k, v, n: cp_decode_attention(
    q, k, v, n, mesh=mesh8, axis="data", **kw))(q, k, v, n)) for q, k, v, n, kw in inp["cp8"]]
mesh = make_mesh((2, 1), ("data", "model"), devices=jax.devices()[:2])
for name, c in inp["cp_decode"].items():
    cfg = JR.get_arch(c["arch"]).reduced
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    logits, caches = jax.jit(lambda p, x: JT.prefill(p, x, cfg, ShardingRules.make(None),
                                                     %(max_seq)d))(params, c["prompts"])
    rules = shape_rules(cfg, SHAPES["long_500k"], mesh)
    step = jax.jit(lambda p, t, cc, n: JT.decode_step(p, t, cc, n, cfg, rules, mesh=mesh,
                                                      shard_kv_seq=True))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    out = {"logits": [], "tokens": []}
    for i in range(c["steps"]):
        lg, caches = step(params, tok, caches, jnp.int32(c["start"] + i))
        out["logits"].append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        out["tokens"].append(np.asarray(tok))
    res[name] = out
m = inp["moe"]
cfg = JR.get_arch("llama4-maverick-400b-a17b").reduced
rules = ShardingRules.make(mesh, dict(JR.get_arch("llama4-maverick-400b-a17b").config.sharding_overrides))
params = JT.init_params(jax.random.PRNGKey(0), cfg)
p = m["prompts"].shape[1]
logits, caches = jax.jit(lambda pr, x: JT.prefill(pr, x, cfg, rules, p + m["steps"] + 1))(
    params, m["prompts"])
out = {"prefill": np.asarray(logits), "logits": []}
step = jax.jit(lambda pr, t, cc, n: JT.decode_step(pr, t, cc, n, cfg, rules, mesh=mesh))
tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
for i in range(m["steps"]):
    lg, caches = step(params, tok, caches, jnp.int32(p + i))
    out["logits"].append(np.asarray(lg))
    tok = jnp.argmax(lg[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
layer = jax.tree.map(lambda a: a[0], params["layers"]["p1"]["mlp"])
moe = jax.jit(lambda lp, x: JM.moe_apply(lp, x, cfg, rules))
y, aux = moe(layer, m["x"])
hlo = analyze(moe.lower(layer, m["x"]).compile().as_text())
out["moe"] = {"y": np.asarray(y), "aux": float(aux),
              "a2a_bytes": int(hlo.coll_breakdown.get("all-to-all", 0))}
(loss, met), grads = jax.jit(jax.value_and_grad(
    lambda pr, b: JT.loss_fn(pr, b, cfg, rules), has_aux=True))(params, m["batch"])
out["loss"], out["aux"] = float(loss), float(met["moe_aux"])
out["grads"] = jax.tree.map(np.asarray, grads)
res["moe"] = out
pickle.dump(res, open(%(path)r + ".out", "wb"))
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(inputs, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_mesh") / "inputs.pkl")
    cases = inputs["cases"]
    payload = {"cp8": inputs["cp8"],
               "cp_decode": {n: dict(c, prompts=inputs["local"][n]["prompts"])
                             for n, c in cases["cp_decode"].items()},
               "moe": cases["moe"]}
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    assert "REF_OK" in run_sharded(_REF % {"path": path, "max_seq": 2 * S_LOCAL}, devices=8,
                                   timeout=600)
    with open(path + ".out", "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# the collective and the attention


def numpy_exchange(xs, split, concat):
    n = len(xs)
    return [np.concatenate([np.split(xs[q], n, axis=split)[r] for q in range(n)], axis=concat)
            for r in range(n)]


@pytest.mark.parametrize("case", range(3))
def test_all_to_all_and_its_backward_equal_a_numpy_exchange(inputs, world, case):
    xs, gs, split, concat = inputs["cases"]["a2a"][case]
    ys = numpy_exchange(list(xs), split, concat)
    grads = numpy_exchange(list(gs), concat, split)
    for rank, r in enumerate(world):
        got = r["a2a"][case]
        assert np.array_equal(got["y"], ys[rank]) and np.array_equal(got["grad"], grads[rank])
        assert got["fwd_bytes"] == xs[rank].nbytes
        assert got["bytes"] == 2 * xs[rank].nbytes and got["calls"] == 2


def test_all_to_all_bytes_equal_the_reference_hlo(world, ref):
    want = ref["moe"]["moe"]["a2a_bytes"]
    for r in world:
        assert r["moe"]["moe"]["bytes"]["all-to-all"] == want > 0
        assert r["moe"]["moe"]["calls"]["all-to-all"] == 2  # one block: out and back
        assert sum(r["moe"]["moe"]["bytes"].values()) == want + 4  # and the aux's mean


@pytest.mark.parametrize("case", range(3), ids=list(PATTERNS))
def test_cp_decode_attention_matches_the_references_4x2_case(inputs, world8, ref, case):
    q, k, v, clen, kw = inputs["cp8"][case]
    plain = decode_attention(t(q), t(k), t(v), t(clen), **kw).numpy()
    for r in world8:
        close(r[case], ref["cp8"][case])
        close(r[case], plain)
        assert np.array_equal(r[case], world8[0][case])


@pytest.mark.parametrize("case", range(3), ids=list(PATTERNS))
def test_cp_decode_attention_on_two_ranks_matches_plain(inputs, world, case):
    q, k, v, clen, kw = inputs["cases"]["cp_attention"][case]
    plain = decode_attention(t(q), t(k), t(v), t(clen), **kw).numpy()
    for r in world:
        close(r["cp_attention"][case], plain)


# ---------------------------------------------------------------------------
# context-parallel decode of the reduced h2o-danube and jamba


@pytest.mark.parametrize("name", list(CP_ARCHS))
def test_cp_decode_matches_the_references_meshed_decode_and_one_device(inputs, world, ref,
                                                                     name):
    local = inputs["local"][name]
    for r in world:
        got = r[name]
        for i in range(CP_STEPS):
            close(got["logits"][i], ref[name]["logits"][i])
            close(got["logits"][i], local["logits"][i])
            assert np.array_equal(got["tokens"][i], ref[name]["tokens"][i])
            assert np.array_equal(got["tokens"][i], local["tokens"][i])
            assert np.array_equal(got["logits"][i], world[0][name]["logits"][i])


@pytest.mark.parametrize("name", list(CP_ARCHS))
def test_cp_decode_writes_land_on_the_owning_rank(inputs, world, name):
    """Step 0 writes position s_local - 1 (rank 0's last slot), step 1
    position s_local (rank 1's first); the ranks' slices put together are
    the one-device caches after every step."""
    want = inputs["local"][name]["caches"]
    before = inputs["cases"]["cp_decode"][name]["caches"]
    for key, c in want.items():
        for leaf, w in c.items():
            got = [r[name]["caches"][key][leaf] for r in world]
            if leaf in ("k", "v"):
                assert all(g.shape[2] == S_LOCAL for g in got)
                whole = np.concatenate(got, axis=2)
                close(whole, w)
                span = slice(CP_START, CP_START + CP_STEPS)
                assert not np.array_equal(whole[:, :, span], before[key][leaf][:, :, span])
                assert np.array_equal(whole[:, :, CP_START + CP_STEPS:],
                                      before[key][leaf][:, :, CP_START + CP_STEPS:])
                assert np.array_equal(got[1][:, :, S_LOCAL - 1], before[key][leaf][:, :, -1])
            else:  # the SSM's state and window: whole on every rank
                for g in got:
                    close(g, w)


@pytest.mark.parametrize("name", list(CP_ARCHS))
def test_cp_decode_c11_at_the_global_length(world, name):
    for r in world:
        assert r[name]["s_local"] == S_LOCAL
        assert f"cache_len {2 * S_LOCAL} is outside the cache's {2 * S_LOCAL}" in r[name]["c11"]
        assert r[name]["c11_untouched"]


@pytest.mark.parametrize("name", list(CP_ARCHS))
def test_cp_decode_moves_one_pmax_and_two_psums_a_layer(world, name):
    cfg = PR.get_arch(CP_ARCHS[name]).reduced
    n_attn = cfg.n_periods * sum(s.kind == "attn" for s in cfg.period())
    b, k, g, d = 2, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    for r in world:
        for nbytes, calls in zip(r[name]["bytes"], r[name]["calls"]):
            assert calls["all-reduce"] == 3 * n_attn and sum(calls.values()) == 3 * n_attn
            assert nbytes["all-reduce"] == n_attn * 4 * (2 * b * k * g + b * k * g * d)


def test_cp_decode_of_a_config_without_attention_runs_plain():
    """mamba2 has no KV cache: the meshed call never reaches a collective,
    so a mesh view with no process group serves it."""
    cfg = PR.get_arch("mamba2-1.3b").reduced
    tree = numpy_tree(JR.get_arch("mamba2-1.3b").reduced)
    params = T.params_from_numpy(tree, cfg, "cpu")
    toks = t(np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16)).astype(np.int32))
    rules = S.ShardingRules.make(None)
    _, caches = T.prefill(params, toks, cfg, rules, 32)
    copy = jax.tree.map(lambda x: x.clone(), caches)
    mesh = types.SimpleNamespace(shape={"data": 2}, axis_names=("data",), coords={"data": 1})
    tok = toks[:, -1:]
    got, _ = T.decode_step(params, tok, caches, 16, cfg, rules, mesh=mesh, shard_kv_seq=True)
    want, _ = T.decode_step(params, tok, copy, 16, cfg, rules)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# cache specs


def _fake_mesh(multi: bool):
    shape = {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16}
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


def axes_of(spec) -> tuple:
    return tuple(S.entry_axes(e) for e in spec)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_cache_pspecs_equal_the_reference(arch, multi):
    from repro.launch.specs import shape_rules as j_shape_rules
    from repro.models.config import SHAPES as J_SHAPES
    from repro_torch.launch.specs import shape_rules
    from repro_torch.models.config import SHAPES

    mesh = _fake_mesh(multi)
    jcfg, cfg = JR.get_arch(arch).config, PR.get_arch(arch).config
    jmod, mod = (JE, E) if cfg.is_encdec else (JT, T)
    for shape in ("decode_32k", "long_500k"):
        want = jmod.cache_pspecs(jcfg, j_shape_rules(jcfg, J_SHAPES[shape], mesh))
        got = mod.cache_pspecs(cfg, shape_rules(cfg, SHAPES[shape], mesh))
        assert jax.tree.map(axes_of, want, is_leaf=lambda x: not isinstance(x, dict)) == \
            jax.tree.map(axes_of, got, is_leaf=lambda x: isinstance(x, tuple))


def test_sharding_record_and_shard_activation():
    mesh = _fake_mesh(False)
    rules = S.ShardingRules.make(mesh)
    assert S.ShardingRules.make(None).sharding("batch", None) is None
    ns = rules.sharding("batch", "vocab")
    assert ns == S.NamedSharding(mesh, (("data",), "model"))
    assert axes_of(ns.spec) == axes_of(JRules.make(mesh).pspec("batch", "vocab"))
    x = torch.zeros(2, 3)
    assert S.shard_activation(x, rules, "batch", None) is x
    with pytest.raises(ValueError, match="1 logical axes for a 2-d tensor"):
        rules.constrain(x, "batch")


# ---------------------------------------------------------------------------
# expert parallelism: the reduced llama4 under its own expert rule


@pytest.fixture(scope="module")
def one_device(inputs):
    """The port's one-device runs of the MoE case: prefill and greedy
    decode of all rows, the MoE layer, its aux on each rank's rows, and one
    AdamW step over 2 microbatches (the ranks' rows)."""
    m = inputs["cases"]["moe"]
    cfg = PR.get_arch(R.MOE_RULE_ARCH).reduced
    rules = S.ShardingRules.make(None)
    params = T.params_from_numpy(m["tree"], cfg, "cpu")
    p = MOE_P
    logits, caches = T.prefill(params, t(m["prompts"]), cfg, rules, p + MOE_STEPS + 1)
    out = {"prefill": logits.numpy(), "logits": []}
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    for i in range(MOE_STEPS):
        lg, caches = T.decode_step(params, tok, caches, p + i, cfg, rules)
        out["logits"].append(lg.numpy())
        tok = torch.argmax(lg[:, -1, :], dim=-1).to(torch.int32)[:, None]
    layer = T._period(params["layers"], 0)["p1"]["mlp"]
    y, _ = M.moe_apply(layer, t(m["x"]), cfg, rules)
    half = MOE_B // 2
    out["moe_y"] = y.numpy()
    out["moe_aux"] = np.mean([float(M.moe_apply(layer, t(m["x"][i:i + half]), cfg, rules)[1])
                              for i in (0, half)])
    batch = {k: t(v) for k, v in m["batch"].items()}
    out["losses"] = [T.loss_fn(params, {k: v[i:i + half] for k, v in batch.items()}, cfg,
                               rules)[1] for i in (0, half)]
    model = ParamTree(T.params_from_numpy(m["tree"], cfg, "cpu"))
    opt = make_optimizer("adamw", lambda step: torch.full((), R.LR))
    state = {"params": model, "opt": opt.init(dict(model.named_parameters())), "step": 0}
    step = make_train_step(lambda mm, b: T.loss_fn(mm.tree(), b, cfg, rules), opt,
                           microbatches=2)
    _, out["metrics"] = step(state, batch)
    out["grads"] = {k: p.grad.numpy() for k, p in model.named_parameters()}
    out["params"] = {k: p.detach().numpy() for k, p in model.named_parameters()}
    return out


def _rows(rank):
    half = MOE_B // 2
    return slice(rank * half, (rank + 1) * half)


def test_expert_parallel_prefill_and_decode_match(world, ref, one_device):
    for rank, r in enumerate(world):
        got = r["moe"]
        close(got["prefill"], ref["moe"]["prefill"][_rows(rank)])
        close(got["prefill"], one_device["prefill"][_rows(rank)])
        for i in range(MOE_STEPS):
            close(got["logits"][i], ref["moe"]["logits"][i][_rows(rank)])
            close(got["logits"][i], one_device["logits"][i][_rows(rank)])


def test_expert_parallel_layer_and_aux_match(world, ref, one_device):
    for rank, r in enumerate(world):
        layer = r["moe"]["moe"]
        close(layer["y"], ref["moe"]["moe"]["y"][_rows(rank)])
        close(layer["y"], one_device["moe_y"][_rows(rank)])
        close(layer["aux"], ref["moe"]["moe"]["aux"])
        close(layer["aux"], one_device["moe_aux"])
        assert layer["aux"] == world[0]["moe"]["moe"]["aux"]


def _block(name, g, rank, cfg):
    """The rank's block of a one-device leaf under ``rank_param_pspecs``."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 1}, axis_names=("data", "model"),
                                 coords={"data": rank, "model": 0})
    rules = S.ShardingRules.make(mesh, dict(PR.get_arch(R.MOE_RULE_ARCH).config
                                            .sharding_overrides))
    return S.shard(g, mesh, T.flat_rank_param_pspecs(cfg, rules)[name])


def test_expert_parallel_loss_and_gradients_match_the_reference(world, ref):
    cfg = PR.get_arch(R.MOE_RULE_ARCH).reduced
    want = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(ref["moe"]["grads"])[0]}
    for rank, r in enumerate(world):
        tr = r["moe"]["train"]
        close(tr["metrics"]["loss"], ref["moe"]["loss"])
        close(tr["metrics"]["moe_aux"], ref["moe"]["aux"])
        assert tr["grads"].keys() == want.keys()
        for name, g in tr["grads"].items():
            close(g, _block(name, want[name], rank, cfg))
        assert tr["a2a_calls"] == 4 * 2  # 2 MoE layers, out and back, forward and backward


def test_expert_parallel_train_step_matches_one_device_microbatches(world, one_device):
    cfg = PR.get_arch(R.MOE_RULE_ARCH).reduced
    close(world[0]["moe"]["train"]["metrics"]["loss"],
          np.mean([float(m["loss"]) for m in one_device["losses"]]))
    for rank, r in enumerate(world):
        tr = r["moe"]["train"]
        split = [n for n, g in tr["grads"].items() if g.shape != one_device["grads"][n].shape]
        assert split and all(n.endswith(("w_gate", "w_up", "w_down")) for n in split)
        for name, g in tr["grads"].items():
            close(g, _block(name, one_device["grads"][name], rank, cfg))
            close(tr["params"][name], _block(name, one_device["params"][name], rank, cfg))
        close(tr["metrics"]["grad_norm"], float(one_device["metrics"]["grad_norm"]))
