"""The port's Mamba-2 SSD and GShard MoE layers, and the MoE, SSM and
hybrid archs served through them, against the JAX package's, on the CPU.

Each layer runs from the same seeded numpy inputs and weights in both
packages (every weight drawn, the norms' and the SSM's zero-initialized
leaves too, so each one moves the output); the archs from the reference's
``init_params`` carried across by ``params_from_numpy``.  Tolerances, and
why:

* f32 everywhere, rtol=atol=1e-5: the products, cumsums and exponentials
  sum in another order in each library (the SSD's chunked dual form, its
  state recurrence and the decode's einsums among them);
* MoE routing is discrete: ``dispatch`` equals the reference's exactly (no
  two router probabilities of a token tie at these seeds), gates and aux
  within 1e-5; "drops" cases are held to drop tokens, so the capacity
  clamp of the one-hot (``jax.nn.one_hot`` gives a zero row past the
  capacity, ``torch.nn.functional.one_hot`` raises) is exercised;
* the reduced jamba, mamba2, grok-1 and llama4 (the consistency cases:
  ``test_torch_lm_consistency.py``): prefill logits, every cache (``h``, ``conv``, ``k``, ``v``) after prefill
  and after 4 greedy decode steps, and each step's logits within 1e-5, the
  greedy tokens equal;
* ``cast_weights``: a bf16 copy made once gives bitwise the numbers of a
  cast on every call; the router, ``A_log``, ``D``, ``dt_bias`` and the
  norms stay f32, as the reference reads them;
* on a (data=2, model=1) world of CPU ranks (``torch_lm_mesh_ranks.py``):
  the MoE's all-to-all dispatch against the dense one's rows, and a
  context-parallel decode step of the reduced jamba against one-device
  decode, within 1e-5 (``test_torch_lm_mesh.py`` holds both to the
  reference's meshed runs).
"""

import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import registry as PR
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.examples import serve_lm
from repro_torch.launch.mesh import Mesh, run_spmd
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDef
import torch_lm_mesh_ranks as MR
from torch_lm_util import B, J_RULES, PROMPT, RULES, assert_runs_match, close, run_both, t

ARCHS = ("jamba-v0.1-52b", "mamba2-1.3b", "grok-1-314b", "llama4-maverick-400b-a17b")
SSM_CFG = ModelConfig(name="ssm-t", family="ssm", n_layers=1, d_model=32, n_heads=1,
                      n_kv_heads=1, d_ff=0, vocab_size=64, ssm_state=8, ssm_head_dim=8,
                      ssm_chunk=8, dtype="float32", remat="none")
MOE_CFG = ModelConfig(name="moe-t", family="moe", n_layers=1, d_model=32, n_heads=2,
                      n_kv_heads=2, d_ff=48, vocab_size=64, n_experts=4, top_k=2,
                      dtype="float32", remat="none")


def numpy_tree(schema, seed: int) -> dict:
    """Seeded numpy weights of `schema`'s shapes: normal times the schema's
    scale, and 0.1 times normal where the schema starts at zero."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, ParamDef):
            x = rng.standard_normal(node.shape).astype(np.float32)
            if node.init != "normal":
                return x * np.float32(0.1)
            return x * np.float32(node.scale if node.scale is not None
                                  else 1.0 / np.sqrt(max(node.fan_in(), 1)))
        return {k: walk(v) for k, v in node.items()}

    return walk(schema)


def both(tree):
    """A numpy tree as jax arrays and as CPU tensors."""
    return jax.tree.map(jnp.asarray, tree), jax.tree.map(lambda a: t(a), tree)


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the SSD layer


@pytest.mark.parametrize("width", [4, 2])
def test_causal_conv(width):
    rng = np.random.default_rng(width)
    x, w = normal(rng, 2, 11, 6), normal(rng, width, 6)
    close(S._causal_conv(t(x), t(w)), JS._causal_conv(jnp.asarray(x), jnp.asarray(w)))


def ssd_inputs(s: int, with_h0: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    b, h, p, n = 2, 4, 8, 6
    dt = np.log1p(np.exp(normal(rng, b, s, h)))  # softplus'd, as mamba_apply gives it
    a = -np.exp(0.3 * normal(rng, h))
    h0 = normal(rng, b, h, p, n) if with_h0 else None
    return [normal(rng, b, s, h, p), normal(rng, b, s, n), normal(rng, b, s, n), dt, a], h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8)], ids=["chunk divides", "chunk does not"])
def test_ssd_chunked(s, chunk, with_h0):
    args, h0 = ssd_inputs(s, with_h0)
    if s % chunk:
        assert S.chunk_size(s, chunk) == 6  # the largest divisor of 30 not above 8
    y, h_t = S._ssd_chunked(*[t(a) for a in args], chunk,
                            h0=None if h0 is None else t(h0))
    jy, jh = jax.jit(JS._ssd_chunked, static_argnums=5)(
        *[jnp.asarray(a) for a in args], chunk, None if h0 is None else jnp.asarray(h0))
    assert y.dtype == h_t.dtype == torch.float32
    close(y, jy)
    close(h_t, jh)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_with_its_state(with_state):
    jp, pp = both(numpy_tree(S.mamba_schema(SSM_CFG), 1))
    rng = np.random.default_rng(2)
    x = normal(rng, 2, 24, SSM_CFG.d_model)
    d_in, h, p, n = S.ssm_dims(SSM_CFG)
    h0 = normal(rng, 2, h, p, n) if with_state else None
    out, h_t = S.mamba_apply(pp, t(x), SSM_CFG, RULES, return_state=True,
                             initial_state=None if h0 is None else t(h0))
    jout, jh = jax.jit(lambda p_, x_, h_: JS.mamba_apply(
        p_, x_, SSM_CFG, J_RULES, return_state=True, initial_state=h_))(
        jp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    close(out, jout)
    close(h_t, jh)
    close(S.mamba_apply(pp, t(x), SSM_CFG, RULES,
                        initial_state=None if h0 is None else t(h0)), jout)


def test_mamba_decode_step_writes_its_state_in_place():
    jp, pp = both(numpy_tree(S.mamba_schema(SSM_CFG), 3))
    rng = np.random.default_rng(4)
    d_in, h, p, n = S.ssm_dims(SSM_CFG)
    x = normal(rng, 2, 1, SSM_CFG.d_model)
    state = {"h": normal(rng, 2, h, p, n), "conv": normal(rng, 2, SSM_CFG.conv_width - 1,
                                                          d_in + 2 * n)}
    pstate = {k: t(v) for k, v in state.items()}
    held = dict(pstate)
    out, new = S.mamba_decode_step(pp, t(x), SSM_CFG, RULES, pstate)
    jout, jnew = jax.jit(lambda p_, x_, s_: JS.mamba_decode_step(p_, x_, SSM_CFG, J_RULES, s_))(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})
    close(out, jout)
    for k in ("h", "conv"):
        assert new[k] is held[k]  # the cache's own tensors
        close(new[k], jnew[k])


def test_prefill_conv_window_is_the_last_pre_conv_channels():
    """The window ``mamba_forward`` slices from its projections equals the
    reference prefill's recomputed one; a sequence shorter than the window
    gets zeros ahead of it."""
    _, pp = both(numpy_tree(S.mamba_schema(SSM_CFG), 5))
    x = t(normal(np.random.default_rng(6), 2, 10, SSM_CFG.d_model))
    d_in, _, _, n = S.ssm_dims(SSM_CFG)
    _, _, conv = S.mamba_forward(pp, x, SSM_CFG, RULES)
    zx, bcdt = x @ pp["zx_proj"], x @ pp["bcdt_proj"]
    want = torch.cat([zx[..., d_in:], bcdt[..., :2 * n]], dim=-1)[:, 10 - 3:]
    assert torch.equal(conv, want)
    _, _, short = S.mamba_forward(pp, x[:, :2], SSM_CFG, RULES)
    assert torch.equal(short[:, 0], torch.zeros_like(short[:, 0]))
    assert torch.equal(short[:, 1:], torch.cat([zx[:, :2, d_in:], bcdt[:, :2, :2 * n]], -1))


# ---------------------------------------------------------------------------
# the MoE layer


def block_drops(dispatch, k: int) -> int:
    g, tb = dispatch.shape[:2]
    return int(round(g * tb * k - float(np.asarray(dispatch).sum())))


@pytest.mark.parametrize("k,capacity", [(1, 16), (2, 16), (2, 5)], ids=["top1", "top2",
                                                                         "top2 drops"])
def test_route_block(k, capacity):
    rng = np.random.default_rng(k + capacity)
    xb, router = normal(rng, 3, 16, 32), normal(rng, 32, 4) * np.float32(0.5)
    disp, gates, aux = M._route_block(t(xb), t(router), k, capacity)
    jdisp, jgates, jaux = JM._route_block(jnp.asarray(xb), jnp.asarray(router), k, capacity)
    assert np.array_equal(disp.numpy(), np.asarray(jdisp))
    close(gates, jgates)
    close(aux, jaux)
    assert (block_drops(jdisp, k) > 0) == (capacity == 5)


MOE_CASES = {  # (top_k, capacity factor, sequence length, block size)
    "top1, one block": (1, 1.25, 48, None),
    "top2, one block": (2, 1.25, 48, None),
    "top1, several blocks": (1, 1.25, 48, 16),
    "top2, several blocks": (2, 1.25, 48, 16),
    "top2, several blocks, drops": (2, 0.5, 48, 16),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply(case, monkeypatch):
    k, cf, s, block = MOE_CASES[case]
    if block is not None:
        monkeypatch.setattr(JM, "MOE_BLOCK_SEQ", block)
        monkeypatch.setattr(M, "MOE_BLOCK_SEQ", block)
    cfg = dataclasses.replace(MOE_CFG, top_k=k, capacity_factor=cf)
    tree = numpy_tree(M.moe_schema(cfg), 7)
    tree["router"] *= np.float32(3.0)  # an uneven load, so a low capacity drops
    jp, pp = both(tree)
    x = normal(np.random.default_rng(8), 2, s, cfg.d_model)
    out, aux = M.moe_apply(pp, t(x), cfg, RULES)
    jout, jaux = JM.moe_apply(jp, jnp.asarray(x), cfg, J_RULES)
    close(out, jout)
    close(aux, jaux)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    tb = M.block_size(s)
    assert s // tb == (1 if block is None else 3)
    cap = M.capacity_of(tb, cfg)
    drops = sum(block_drops(JM._route_block(jnp.asarray(x[:, i:i + tb]),
                                            jnp.asarray(tree["router"]), k, cap)[0], k)
                for i in range(0, s, tb))
    if "drops" in case:
        assert drops > 0


@pytest.fixture(scope="module")
def mesh_world(arch_runs):
    """One (data=2, model=1) world of CPU ranks: a MoE layer dispatched by
    all-to-all (``MOE_CFG``, experts over ``data``, batch 4) and one
    context-parallel decode step of the reduced jamba from its prefill
    caches (100 positions: 50 a rank; position 96 on rank 1)."""
    tree = numpy_tree(M.moe_schema(MOE_CFG), 9)
    x = normal(np.random.default_rng(10), 4, 8, MOE_CFG.d_model)
    _, port = arch_runs["jamba-v0.1-52b"]
    cp = dict(arch="jamba-v0.1-52b", tree=jax.tree.map(lambda a: a.numpy(), port["params"]),
              caches=jax.tree.map(lambda a: a.numpy().copy(), port["caches"]),
              token=np.full((B, 1), 7, np.int32), start=PROMPT, steps=1)
    world = run_spmd(MR.ssm_moe_rank, (2, 1), ("data", "model"), device="cpu",
                     args=(dict(cfg_fields=dataclasses.asdict(MOE_CFG), tree=tree, x=x), cp),
                     timeout=600)
    return tree, x, world


def test_moe_dispatches_by_all_to_all_where_the_reference_does(mesh_world, monkeypatch):
    """Experts over the batch's mesh axis (llama4's rule) on a mesh whose
    data axis divides the experts and the batch: the reference's
    ``_moe_apply_a2a``.  Each rank's rows equal the dense dispatch's (routing
    is per batch row), the aux is the mean of the ranks' rows' aux.  A
    rank's block of one row is a global batch of two, which the axis
    divides: it takes the all-to-all too, where the reference would
    dispatch a global batch of one densely."""
    tree, x, world = mesh_world
    _, pp = both(tree)
    out, _ = M.moe_apply(pp, t(x), MOE_CFG, RULES)
    auxes = [float(M.moe_apply(pp, t(x[i:i + 2]), MOE_CFG, RULES)[1]) for i in (0, 2)]
    for rank, r in enumerate(world):
        close(t(r["moe"]["y"]), out[2 * rank:2 * rank + 2])
        close(torch.tensor(r["moe"]["aux"]), np.mean(auxes))
        assert r["moe"]["calls"] == 2 and r["moe"]["bytes"] > 0
    mesh = Mesh(shape={"data": 2, "model": 1}, rank=0, device=torch.device("cpu"),
                transport="gloo")
    rules = ShardingRules.make(mesh, {"experts": "data"})
    taken = []
    monkeypatch.setattr(M, "_moe_apply_a2a",
                        lambda *a, axis: taken.append((a[1].shape[0], axis)) or (a[1], None))
    M.moe_apply(pp, t(x[:1]), MOE_CFG, rules)
    assert taken == [(1, "data")]


# ---------------------------------------------------------------------------
# the archs: prefill, caches, greedy decode


@pytest.fixture(scope="module")
def arch_runs():
    return {arch: run_both(JR.get_arch(arch).reduced, PR.get_arch(arch).reduced)
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_prefill_caches_and_greedy_decode_match(arch_runs, arch):
    ref, port = arch_runs[arch]
    kinds = {k for c in port["caches"].values() for k in c}
    assert kinds == {"jamba-v0.1-52b": {"k", "v", "h", "conv"}, "mamba2-1.3b": {"h", "conv"}}.get(
        arch, {"k", "v"})
    assert_runs_match(ref, port)


def test_params_from_numpy_carries_every_leaf(arch_runs):
    ref, port = arch_runs["jamba-v0.1-52b"]
    got = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda x: x.numpy(), port["params"]))[0]
    want = jax.tree_util.tree_flatten_with_path(ref["tree"])[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    names = {str(p[-1].key) for p, _ in got}
    assert {"zx_proj", "bcdt_proj", "conv_x", "conv_bc", "A_log", "D", "dt_bias", "norm_w",
            "out_proj", "router", "w_gate", "w_up", "w_down"} <= names
    for (_, g), (_, w) in zip(got, want):
        assert np.array_equal(g, w)


def test_cast_weights_of_the_new_leaves(arch_runs):
    cfg = dataclasses.replace(PR.get_arch("jamba-v0.1-52b").reduced, dtype="bfloat16")
    ref, port = arch_runs["jamba-v0.1-52b"]
    params = port["params"]
    once = T.cast_weights(params, cfg)
    mamba, moe = once["layers"]["p0"]["mamba"], once["layers"]["p1"]["mlp"]
    for name in ("zx_proj", "bcdt_proj", "conv_x", "conv_bc", "out_proj"):
        assert mamba[name].dtype == torch.bfloat16, name
    for name in ("A_log", "D", "dt_bias", "norm_w"):
        assert mamba[name].dtype == torch.float32, name
    assert moe["router"].dtype == torch.float32
    assert all(moe[n].dtype == torch.bfloat16 for n in ("w_gate", "w_up", "w_down"))
    toks = t(port["prompts"])
    a, ca = T.prefill(params, toks, cfg, RULES, PROMPT + 1)
    b, cb = T.prefill(once, toks, cfg, RULES, PROMPT + 1)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    tok = torch.argmax(a[:, -1], -1).to(torch.int32)[:, None]
    la, _ = T.decode_step(params, tok, ca, PROMPT, cfg, RULES)
    lb, _ = T.decode_step(once, tok, cb, PROMPT, cfg, RULES)
    assert torch.equal(la, lb)
    for (pa, xa), (_, xb) in zip(*(jax.tree_util.tree_flatten_with_path(c)[0] for c in (ca, cb))):
        assert torch.equal(xa, xb), pa


# ---------------------------------------------------------------------------
# decode on a mesh (ROADMAP C), C11 and pure SSM decode


def decode_once(arch_runs, arch, **kw):
    """One port decode step from copies of the prefill caches."""
    _, port = arch_runs[arch]
    cfg = PR.get_arch(arch).reduced
    caches = jax.tree.map(lambda x: x.clone(), port["caches"])
    tok = torch.full((B, 1), 7, dtype=torch.int32)
    return T.decode_step(port["params"], tok, caches, PROMPT, cfg, RULES, **kw)


def test_shard_kv_seq_without_a_data_axis_runs_plain_decode(arch_runs):
    """The reference takes context-parallel decode only on a mesh with a
    ``data`` axis; on one without it runs plain ``decode_attention``."""
    arch = "jamba-v0.1-52b"
    ref, port = arch_runs[arch]
    jcfg = JR.get_arch(arch).reduced
    mesh = Mesh(shape={"model": 1}, rank=0, device=torch.device("cpu"), transport="gloo")
    got, got_c = decode_once(arch_runs, arch, mesh=mesh, shard_kv_seq=True)
    plain, plain_c = decode_once(arch_runs, arch)
    assert torch.equal(got, plain)
    for x, y in zip(jax.tree.leaves(got_c), jax.tree.leaves(plain_c)):
        assert torch.equal(x, y)
    jmesh = j_make_mesh((1,), ("model",), devices=jax.devices()[:1])
    want, _ = JT.decode_step(jax.tree.map(jnp.asarray, ref["tree"]),
                             jnp.full((B, 1), 7, jnp.int32),
                             jax.tree.map(jnp.asarray, ref["caches"]), jnp.int32(PROMPT),
                             jcfg, J_RULES, mesh=jmesh, shard_kv_seq=True)
    close(got, want)


def test_shard_kv_seq_with_a_data_axis_decodes_context_parallel(arch_runs, mesh_world):
    """On a mesh with a ``data`` axis the reference takes
    ``cp_decode_attention``: each rank's logits equal one-device decode's,
    and only rank 1, whose slice holds position 96, writes it."""
    _, port = arch_runs["jamba-v0.1-52b"]
    plain, plain_c = decode_once(arch_runs, "jamba-v0.1-52b")
    half = port["caches"]["p4"]["k"].shape[2] // 2
    for rank, r in enumerate(mesh_world[2]):
        close(t(r["cp"]["logits"][0]), plain)
        got = r["cp"]["caches"]["p4"]["k"]
        want = plain_c["p4"]["k"][:, :, rank * half:(rank + 1) * half].numpy()
        if rank == 0:
            assert np.array_equal(got, want)
        else:
            close(t(got), want)
    # a config with no attention position never reaches cp_decode_attention
    mesh = Mesh(shape={"data": 2, "model": 1}, rank=0, device=torch.device("cpu"),
                transport="gloo")
    got, _ = decode_once(arch_runs, "mamba2-1.3b", mesh=mesh, shard_kv_seq=True)
    assert torch.equal(got, decode_once(arch_runs, "mamba2-1.3b")[0])


def test_c11_still_raises_for_a_hybrid(arch_runs):
    _, port = arch_runs["jamba-v0.1-52b"]
    cfg = PR.get_arch("jamba-v0.1-52b").reduced
    caches = port["caches_after"]
    kept = jax.tree.map(lambda x: x.clone(), caches)
    tok = torch.full((B, 1), 7, dtype=torch.int32)
    for n in (PROMPT + 4, -1):  # max_seq is the prompt and 4 decode steps
        with pytest.raises(ValueError, match="outside the cache"):
            T.decode_step(port["params"], tok, caches, n, cfg, RULES)
    for x, y in zip(jax.tree.leaves(caches), jax.tree.leaves(kept)):
        assert torch.equal(x, y)


def test_pure_ssm_decodes_past_max_seq_as_the_reference(arch_runs):
    """mamba2 keeps no KV cache, so nothing bounds ``cache_len``: the
    reference's decode reads it nowhere, and the port's runs too."""
    ref, port = arch_runs["mamba2-1.3b"]
    jcfg = JR.get_arch("mamba2-1.3b").reduced
    far = 10 * (PROMPT + 4)
    cfg = PR.get_arch("mamba2-1.3b").reduced
    caches = jax.tree.map(lambda x: x.clone(), port["caches"])
    tok = torch.full((B, 1), 7, dtype=torch.int32)
    got, _ = T.decode_step(port["params"], tok, caches, far, cfg, RULES)
    want, _ = JT.decode_step(jax.tree.map(jnp.asarray, ref["tree"]),
                             jnp.full((B, 1), 7, jnp.int32),
                             jax.tree.map(jnp.asarray, ref["caches"]), jnp.int32(far),
                             jcfg, J_RULES)
    close(got, want)


# ---------------------------------------------------------------------------
# the example


def test_serve_lm_example_serves_jamba_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = serve_lm.main(["--device", "cpu", "--batch", "2", "--gen", "5"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "jamba-smoke: prefilled 2x48; decoding..."
    assert lines[1].startswith("decoded 4 steps x 2 requests in ") and "tok/s) [cpu]" in lines[1]
    assert "; sample: [" in lines[1]
    assert out["tokens"].shape == (2, 5) and out["card"] == "cpu"


def test_serve_lm_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main([])

