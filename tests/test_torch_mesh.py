"""The meshed paths of the port on CPU ranks over gloo, against the JAX
package's meshed and local paths and against the port's one-device path.

Each world is a ``launch.mesh.run_spmd`` call (spawned ranks, a
``file://`` rendezvous in a fresh temporary directory, no fixed port) that
runs a rank program of ``torch_mesh_ranks.py``; a module-scoped fixture
runs each world once for the tests that read it.  Tolerances, and why:

* global batches bitwise the port's one-device batches (the same kernels'
  plain versions on the same rows); against the reference, integers and
  labels bitwise, dense to rtol=atol=1e-6 with NaN equal (log1p: 1 ulp);
* collective-permute bytes per rank exactly the reference's compiled HLO
  count (``hlo_cost.analyze``) for the same placement and mesh;
* the row-sharded bag to 2e-5 (the reference's bound for its own sharded
  bag) and its table gradient to 1e-6 against the reference's local
  gradient: each pooled value sums the same ids in another order;
* the meshed train step's losses within 1e-5 of the one-device step's
  and of the reference's meshed step's (on fake devices), its clip norm
  within 1e-6 relative: gradients differ only in summation order;
* ``quantize_int8``: q bitwise, scale and residual within 1 ulp;
* the compressed step's first update: its gradients the pods' int8 mean
  recomputed in numpy (1 ulp) and within the quantization bound of the
  f32 mean, its error feedback the residual (1 ulp); its parameters
  within 1e-3 of the uncompressed step's (the reference's bound, which
  AdamW's first step, moving each parameter by under lr, always meets).
"""

import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from conftest import run_sharded
from repro.configs.registry import get_recsys as j_get_recsys
from repro.core.presto import PreStoEngine
from repro.core.preprocess import pages_from_partition as j_pages
from repro.core.spec import TransformSpec as JSpec
from repro.data.synth import SyntheticRecSysSource as JSource
from repro.distributed import sharding as JS
from repro.models import recsys as JRS
from repro.train import compression as JC
from repro_torch.configs.registry import get_recsys
from repro_torch.core import opgraph
from repro_torch.core.presto import TorchPreStoEngine, shard_pages
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import Mesh, axis_ranks, choose_transport, run_spmd
from repro_torch.models import recsys as RS
from repro_torch.train import (
    adamw,
    init_state,
    make_train_step,
    opt_state_pspecs,
    quantize_int8,
    warmup_cosine,
)

DENSE_TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=True)
LR = (1e-3, 2, 100)
TRAIN_ROWS = 64


def local_mesh(shape: dict, rank: int = 0) -> Mesh:
    """A mesh view with no process groups: enough to slice blocks."""
    return Mesh(dict(shape), rank, torch.device("cpu"), "gloo")


# ---------------------------------------------------------------------------
# rules, layout, transport (no world)


def _j_mesh(axes):
    return types.SimpleNamespace(axis_names=tuple(axes))


def axes_of(spec) -> tuple:
    """A spec as the mesh axes of each entry (jax's PartitionSpec writes a
    1-tuple entry as its one name)."""
    return tuple(S.entry_axes(e) for e in spec)


def _flat_tree(tree: dict) -> dict:
    """A nested params dict under the DLRM's ``named_parameters`` names."""
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out.update({f"{key}.{k}": v for k, v in node.items()})
        else:
            out[key] = node
    return out


@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model")])
def test_sharding_rules_equal_the_reference(axes):
    ours, theirs = S.ShardingRules.make(_j_mesh(axes)), JS.ShardingRules.make(_j_mesh(axes))
    assert ours.mapping == theirs.mapping
    for name in S.DEFAULT_RULES:
        assert axes_of(ours.pspec(name)) == axes_of(theirs.pspec(name)), name
        assert (axes_of(ours.pspec(name, "fsdp", "batch"))
                == axes_of(theirs.pspec(name, "fsdp", "batch")))
    for rm in ("rm1", "rm2"):
        ref = JRS.param_pspecs(j_get_recsys(rm, reduced=True), theirs)
        flat = RS.flat_param_pspecs(get_recsys(rm, reduced=True), ours)
        for name, spec in flat.items():
            group, _, leaf = name.partition(".")
            want = ref[group][leaf] if leaf else ref[group]
            assert axes_of(spec) == axes_of(want), name


def test_opt_state_inherits_param_specs():
    cfg = get_recsys("rm1", reduced=True)
    rules = S.ShardingRules.make(_j_mesh(("data", "model")))
    specs = RS.flat_param_pspecs(cfg, rules)
    params = {k: torch.empty(v.shape, device="meta")
              for k, v in _flat_tree(RS.model_schema(cfg)).items()}
    got = opt_state_pspecs(adamw(warmup_cosine(*LR)), params, specs)
    assert got["m"] == specs and got["v"] == specs and got["count"] == ()
    assert specs["tables"] == (None, "model", None) and specs["bottom.w0"] == ("data", None)


def test_axis_ranks_and_coords_are_row_major():
    assert axis_ranks((2, 3), 0) == [[0, 3], [1, 4], [2, 5]]
    assert axis_ranks((2, 3), 1) == [[0, 1, 2], [3, 4, 5]]
    assert local_mesh({"pod": 2, "data": 2, "model": 2}, 6).coords == {
        "pod": 1, "data": 1, "model": 0}


def test_transport_follows_the_rank_device_map():
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    assert choose_transport([cpu] * 4) == "gloo"
    assert choose_transport([c0, c0]) == "gloo-staged"
    with pytest.raises(ValueError, match="one kind of device"):
        choose_transport([cpu, c0])
    if torch.distributed.is_nccl_available():
        assert choose_transport([c0, c1]) == "nccl"
    else:
        with pytest.raises(ValueError, match="not built"):
            choose_transport([c0, c1])


def test_a_rank_that_raises_makes_run_spmd_raise():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 raised.*fails on purpose"):
        run_spmd(R.failing_rank, (2,), ("data",), device="cpu", timeout=120)


@pytest.mark.parametrize("n_data", [3, 16])
def test_a_data_size_that_does_not_divide_raises(n_data):
    # 256 rows: 3 divides no page; 16 divides the rows but not the 8
    # length row groups
    src = R.small_source()
    spec = TransformSpec.from_source(src)
    engine = TorchPreStoEngine(spec, device="cpu")
    pages = engine.stage_partition(PartitionedStore(2, 2, src), 0)
    with pytest.raises(ValueError, match="does not divide"):
        shard_pages(pages, local_mesh({"data": n_data, "model": 1}))


def test_meshed_engine_refuses_megabatches_and_streams():
    src = R.small_source()
    engine = TorchPreStoEngine(TransformSpec.from_source(src),
                               local_mesh({"data": 2, "model": 1}), device="cpu")
    store = PartitionedStore(2, 2, src)
    with pytest.raises(ValueError, match="mesh"):
        next(engine.produce_stream(store, [0, 1]))
    with pytest.raises(ValueError, match="mesh"):
        engine.preprocess_megabatch({"label_words": torch.zeros(2, 256, dtype=torch.int32)})


def test_quantize_int8_equals_the_reference():
    rng = np.random.default_rng(0)
    cases = [rng.normal(size=(64, 33)).astype(np.float32) * 1e-3,
             np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, -127.0], np.float32),  # ties
             np.zeros((5,), np.float32)]
    for g in cases:
        q, scale, res = quantize_int8(torch.from_numpy(g))
        jq, js, jr = (np.asarray(x) for x in JC.quantize_int8(jnp.asarray(g)))
        assert np.array_equal(q.numpy(), jq)
        np.testing.assert_array_max_ulp(scale.numpy(), js, maxulp=1)
        np.testing.assert_array_max_ulp(res.numpy(), jr, maxulp=1)


# ---------------------------------------------------------------------------
# meshed preprocess_global, one (2, 2) world


@pytest.fixture(scope="module")
def preprocess_world():
    return run_spmd(R.preprocess_rank, (2, 2), ("data", "model"), device="cpu")


@pytest.fixture(scope="module")
def local_batches():
    """The port's one-device batch and the reference's, of partition 0."""
    src = R.small_source()
    ours = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu").produce_batch(
        PartitionedStore(2, 2, src), 0)
    jsrc = JSource(R.SMALL, rows=R.ROWS)
    jspec = JSpec.from_source(jsrc)
    pages = {k: jnp.asarray(v) for k, v in j_pages(jsrc.partition(0), jspec).items()}
    theirs = PreStoEngine(jspec, None, placement="presto").preprocess_local(pages)
    return ({k: v.numpy() for k, v in ours.items()},
            {k: np.asarray(v) for k, v in theirs.items()})


def hold_reference(got: dict, theirs: dict) -> None:
    for key, want in theirs.items():
        if key == "dense":
            np.testing.assert_allclose(got[key], want, **DENSE_TOL)
        else:
            assert np.array_equal(got[key], want), key


@pytest.mark.parametrize("placement", list(R.PLACEMENTS))
def test_global_batches_equal_local(placement, preprocess_world, local_batches):
    ours, theirs = local_batches
    got = preprocess_world[0]["batches"][placement]
    for key, want in ours.items():
        assert got[key].dtype == want.dtype and np.array_equal(got[key], want, equal_nan=True), key
    hold_reference(got, theirs)


def test_host_mesh_takes_the_references_shape_for_four_ranks(preprocess_world):
    assert all(r["host_mesh"] == {"data": 2, "model": 2} for r in preprocess_world)


def test_presto_makes_no_collective_call(preprocess_world, local_batches):
    ours, _ = local_batches
    for r in preprocess_world:
        assert sum(r["calls"]["presto"].values()) == 0 and sum(r["bytes"]["presto"].values()) == 0
    # and ran with every collective raising: each rank holds its data block
    for rank, r in enumerate(preprocess_world):
        block = {k: S.shard(v, local_mesh({"data": 2, "model": 2}, rank), ("data",))
                 for k, v in ours.items()}
        for key, want in block.items():
            assert np.array_equal(r["raising"][key], want, equal_nan=True), key


def test_dedup_under_a_mesh_equals_the_inflated_local_batch(preprocess_world):
    src = R.small_source(R.DEDUP)
    engine = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    want = {k: v.numpy() for k, v in engine.produce_batch(PartitionedStore(2, 2, src), 0).items()}
    for placement in ("presto", "disagg"):
        got = preprocess_world[0]["dedup"][placement]
        for key in want:
            assert np.array_equal(got[key], want[key], equal_nan=True), (placement, key)


_HLO = """
import json, jax, jax.numpy as jnp
from repro.core.presto import PreStoEngine
from repro.core.preprocess import pages_from_partition
from repro.core.spec import TransformSpec
from repro.data.synth import RMDataConfig, SyntheticRecSysSource
from repro.launch.hlo_cost import analyze
from repro.launch.mesh import make_mesh
cfg = RMDataConfig("t", 4, 3, 4, 8, 2, 32, 1 << 16, 1024, rows_per_partition=256)
src = SyntheticRecSysSource(cfg, rows=256)
spec = TransformSpec.from_source(src)
mesh = make_mesh((2, 2), ("data", "model"))
pages = {k: jnp.asarray(v) for k, v in pages_from_partition(src.partition(0), spec).items()}
out = {}
for name, placement in (("hybrid", {"gen": "host", "lengths": "host"}), ("disagg", "disagg")):
    eng = PreStoEngine(spec, mesh, placement=placement)
    c = analyze(jax.jit(eng.preprocess_global).lower(pages).compile().as_text())
    out[name] = [c.coll_bytes, c.coll_breakdown.get("collective-permute", 0)]
print("HLO", json.dumps(out))
"""


@pytest.fixture(scope="module")
def hlo_bytes():
    out = run_sharded(_HLO, devices=4)
    return json.loads(out.split("HLO ", 1)[1])


@pytest.mark.parametrize("placement", ["hybrid", "disagg"])
def test_permute_bytes_equal_the_reference_hlo(placement, preprocess_world, hlo_bytes):
    coll, permute = hlo_bytes[placement]
    assert coll == permute > 0
    spec = TransformSpec.from_source(R.small_source())
    page_b = opgraph.family_page_bytes(spec, R.ROWS)
    out_b = opgraph.family_batch_bytes(spec, R.ROWS)
    for r in preprocess_world:
        fams = r["host_families"][placement]
        skip_gen = "gen" in fams and "dense" in fams
        formula = sum(((0 if f == "gen" and skip_gen else page_b[f]) + out_b[f]) // 2
                      for f in fams)
        assert r["bytes"][placement]["collective-permute"] == permute == formula
        assert r["bytes"][placement]["all-reduce"] == r["bytes"][placement]["all-gather"] == 0


# ---------------------------------------------------------------------------
# row-sharded embedding, one (2, 2) world


@pytest.fixture(scope="module")
def embedding_case():
    rcfg = j_get_recsys("rm1", reduced=True)
    params = JRS.init_params(jax.random.PRNGKey(0), rcfg)
    tables = np.asarray(params["tables"])
    rng = np.random.default_rng(0)
    B, S_, L, G = 16, rcfg.data.n_sparse, rcfg.data.max_sparse_len, rcfg.data.n_generated
    mids = rng.integers(0, rcfg.data.embedding_rows, (B, S_, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, (B, S_)).astype(np.int32)
    oids = rng.integers(0, rcfg.data.embedding_rows, (B, G)).astype(np.int32)
    w = rng.normal(size=(B, rcfg.n_tables, rcfg.emb_dim)).astype(np.float32)
    rules = JS.ShardingRules.make(None)

    def f(t):
        bag = JRS.embedding_bag(t, jnp.asarray(mids), jnp.asarray(lens), jnp.asarray(oids),
                                rcfg, rules)
        return jnp.sum(bag * jnp.asarray(w)), bag

    (_, pooled), grad = jax.value_and_grad(f, has_aux=True)(params["tables"])
    world = run_spmd(R.embedding_rank, (2, 2), ("data", "model"), device="cpu",
                     args=(tables, mids, lens, oids, w))
    return world, np.asarray(pooled), np.asarray(grad)


def test_rowsharded_embedding_matches_local(embedding_case):
    world, pooled, _ = embedding_case
    for r in world:
        c = r["coords"]
        want = S.shard(pooled, local_mesh({"data": 2, "model": 2}, c["data"] * 2 + c["model"]),
                       ("data",))
        np.testing.assert_allclose(r["pooled"], want, rtol=2e-5, atol=2e-5)


def test_rowsharded_embedding_table_gradient_matches_local(embedding_case):
    world, _, grad = embedding_case
    for r in world:
        c = r["coords"]
        want = S.shard(grad, local_mesh({"data": 2, "model": 2}, c["data"] * 2 + c["model"]),
                       (None, "model", None))
        assert np.abs(want).sum() > 0
        np.testing.assert_allclose(r["grad"], want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# meshed train step, one (2, 2) world


def _train_inputs(n_batches: int):
    rcfg = get_recsys("rm2", reduced=True)
    params = jax.tree.map(np.asarray, JRS.init_params(jax.random.PRNGKey(1),
                                                      j_get_recsys("rm2", reduced=True)))
    src = SyntheticRecSysSource(rcfg.data, rows=TRAIN_ROWS)
    engine = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    store = PartitionedStore(n_batches, 2, src)
    batches = [{k: v.numpy() for k, v in engine.produce_batch(store, pid).items()}
               for pid in range(n_batches)]
    return rcfg, params, batches


@pytest.fixture(scope="module")
def train_case():
    rcfg, params, batches = _train_inputs(3)
    world = run_spmd(R.train_rank, (2, 2), ("data", "model"), device="cpu",
                     args=(params, batches, LR))
    model = RS.params_from_numpy(params, rcfg, "cpu")
    opt = adamw(warmup_cosine(*LR))
    state = init_state(model, opt)
    step = make_train_step(lambda m, b: RS.loss_fn(m, b, rcfg), opt)
    losses, norms = [], []
    for batch in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = {k: v.detach().numpy() for k, v in model.named_parameters()}
    return world, losses, norms, final


def test_meshed_train_step_matches_one_device(train_case):
    world, losses, norms, _ = train_case
    for r in world:
        np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["norms"], norms, rtol=1e-6, atol=0)
    assert losses[-1] != losses[0]


def hold_blocks(world, final: dict) -> None:
    """Every rank's blocks after 3 steps against the same blocks of
    `final`, to lr/100 except Adam's rounding-noise share (at most 1e-5 of
    a leaf, within 2 lr a step: see test_torch_train)."""
    lr = LR[0]
    for r in world:
        mesh = local_mesh({"data": 2, "model": 2}, r["coords"]["data"] * 2 + r["coords"]["model"])
        for name, got in r["params"].items():
            want = S.shard(final[name], mesh, r["specs"][name])
            diff = np.abs(got - want)
            assert diff.max() <= 2 * lr * 3, name
            assert (diff > lr / 100).sum() <= max(1, math.ceil(1e-5 * diff.size)), name


def test_meshed_train_step_parameters_match_one_device(train_case):
    world, _, _, final = train_case
    hold_blocks(world, final)


_REF_TRAIN = """
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_recsys
from repro.distributed.sharding import ShardingRules
from repro.launch.mesh import make_mesh
from repro.models import recsys as RS
from repro.train import adamw, make_train_step, warmup_cosine
path, out, lr, n = %r
z = np.load(path)
cfg = get_recsys("rm2", reduced=True)
mesh = make_mesh((2, 2), ("data", "model"))
rules = ShardingRules.make(mesh)
specs = RS.param_pspecs(cfg, rules)
put = lambda x, spec: jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
params = {}
for key in z.files:
    if key.startswith("p/"):
        name = key[2:]
        group, _, leaf = name.partition(".")
        if leaf:
            params.setdefault(group, {})[leaf] = put(z[key], specs[group][leaf])
        else:
            params[group] = put(z[key], specs[group])
opt = adamw(warmup_cosine(*lr))
state = {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}
step = jax.jit(make_train_step(lambda p, b: RS.loss_fn(p, b, cfg, rules), opt))
rows = rules.mapping["batch"]
losses, norms = [], []
for i in range(n):
    batch = {k[len(f"b{i}/"):]: put(z[k], P(rows, *([None] * (z[k].ndim - 1))))
             for k in z.files if k.startswith(f"b{i}/")}
    state, m = step(state, batch)
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
final = {}
for group, node in state["params"].items():
    if isinstance(node, dict):
        final.update({f"{group}.{k}": np.asarray(v) for k, v in node.items()})
    else:
        final[group] = np.asarray(node)
np.savez(out, **final)
print("REF", json.dumps({"losses": losses, "norms": norms}))
"""


@pytest.fixture(scope="module")
def reference_train(train_case, tmp_path_factory):
    """The reference's meshed train step (``make_train_step`` over its
    meshed ``loss_fn``, shard_map bag and all) on a (2, 2) mesh of fake
    devices, from the same params and batches as ``train_case``."""
    _, params, batches = _train_inputs(3)
    work = tmp_path_factory.mktemp("reference_train")
    inputs = {f"p/{k}": v for k, v in _flat_tree(params).items()}
    for i, batch in enumerate(batches):
        inputs.update({f"b{i}/{k}": v for k, v in batch.items()})
    np.savez(work / "inputs.npz", **inputs)
    args = (str(work / "inputs.npz"), str(work / "final.npz"), LR, len(batches))
    out = json.loads(run_sharded(_REF_TRAIN % (args,), devices=4).split("REF ", 1)[1])
    with np.load(work / "final.npz") as z:
        return out["losses"], out["norms"], {k: z[k] for k in z.files}


def test_meshed_train_step_matches_the_references_meshed_step(train_case, reference_train):
    world = train_case[0]
    losses, norms, final = reference_train
    for r in world:
        np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["norms"], norms, rtol=1e-6, atol=0)
    hold_blocks(world, final)


# ---------------------------------------------------------------------------
# compression and the compressed step, one (pod, data, model) = (2, 1, 2) world

POD_SPECS = {"a": (None, "model"), "b": ()}


@pytest.fixture(scope="module")
def pods_case():
    rng = np.random.default_rng(3)
    grads = {"a": rng.normal(size=(2, 6, 8)).astype(np.float32),
             "b": rng.normal(size=(2, 5)).astype(np.float32) * 1e-3}
    errs = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-4 for k, v in grads.items()}
    rcfg, params, batches = _train_inputs(1)
    world = run_spmd(R.pods_rank, (2, 1, 2), ("pod", "data", "model"), device="cpu",
                     args=((grads, errs, POD_SPECS), (params, batches[0], LR)))
    return world, grads, errs


def test_crosspod_compressed_mean_equals_numpy(pods_case):
    world, grads, errs = pods_case
    want_mean, want_err = {}, {}
    for k, g in grads.items():
        qs, ss = [], []
        for pod in range(2):
            x = g[pod] + errs[k][pod]
            scale = np.float32(np.max(np.abs(x)) / np.float32(127.0) + np.float32(1e-12))
            q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
            qs.append(q)
            ss.append(scale)
            want_err[(k, pod)] = x - q.astype(np.float32) * scale
        want_mean[k] = np.mean(np.stack([q.astype(np.float32) * s for q, s in zip(qs, ss)]), 0)
    for r in (w["compression"] for w in world):
        c = r["coords"]
        mesh = local_mesh({"pod": 2, "data": 1, "model": 2}, c["pod"] * 2 + c["model"])
        for k in grads:
            np.testing.assert_array_max_ulp(
                r["mean"][k], S.shard(want_mean[k], mesh, POD_SPECS[k]), maxulp=1)
            np.testing.assert_array_max_ulp(
                r["err"][k], S.shard(want_err[(k, c["pod"])], mesh, POD_SPECS[k]), maxulp=1)


def test_compressed_step_tracks_uncompressed_with_int8_on_the_pod_hop(pods_case):
    world, _, _ = pods_case
    for r in world:
        s = r["step"]
        assert s["losses"][1] < s["losses"][0]
        assert s["max_diff"] < 1e-3, s["max_diff"]
        # the pod hop: per leaf, its int8 block and a 4-byte scale
        n_leaves = len(s["numel"])
        assert s["compressed"]["calls"]["all-gather"] == 2 * n_leaves
        assert s["compressed"]["bytes"]["all-gather"] == sum(s["numel"].values()) + 4 * n_leaves
        # against an f32 all-reduce of every block over the pod
        assert s["uncompressed"]["calls"]["all-gather"] == 0
        assert s["uncompressed"]["bytes"]["all-reduce"] >= 4 * sum(s["numel"].values())


def _pod_tensor(world, pod: int, blocks: str, name: str, spec: tuple) -> np.ndarray:
    """Pod `pod`'s whole tensor `name` from its ranks' `blocks` (data is 1,
    so a leaf splits over model only)."""
    ranks = sorted((r for r in world if r["coords"]["pod"] == pod),
                   key=lambda r: r["coords"]["model"])
    get = (lambda r: r["err"][name]) if blocks == "err" else (lambda r: r["grads"][blocks][name])
    dims = [d for d, e in enumerate(spec) if "model" in S.entry_axes(e)]
    if not dims:
        return get(ranks[0])
    return np.concatenate([get(r) for r in ranks], axis=dims[0])


def test_compressed_step_hands_the_optimizer_the_int8_mean_of_the_pods(pods_case):
    """The gradients of the first compressed update, against a numpy
    recomputation from each pod's mean gradient (the pod-averaged
    uncompressed step's, the error feedback being 0): the mean of the
    pods' int8-quantized gradients (1 ulp), and so within the quantization
    bound (scale / 2 per pod, averaged) of the f32 mean over pod and data;
    and the new error feedback the pod's residual (1 ulp).  The pods' mean
    gradients differ by more than the bound, so a step that kept its pod's
    own mean fails."""
    world = [w["step"] for w in pods_case[0]]
    for name, spec in world[0]["specs"].items():
        xs = [_pod_tensor(world, pod, "pod", name, spec) for pod in (0, 1)]
        scales = [np.float32(np.max(np.abs(x)) / np.float32(127.0) + np.float32(1e-12))
                  for x in xs]
        deq = [np.clip(np.round(x / sc), -127, 127).astype(np.float32) * sc
               for x, sc in zip(xs, scales)]
        want = np.mean(np.stack(deq), 0)
        exact = _pod_tensor(world, 0, "global", name, spec)
        bound = (scales[0] + scales[1]) / 4 + 1e-6 * np.max(np.abs(exact))
        assert np.max(np.abs(xs[0] - xs[1])) / 2 > bound, name
        for pod in (0, 1):
            got = _pod_tensor(world, pod, "compressed", name, spec)
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
            assert np.max(np.abs(got - exact)) <= bound, name
            np.testing.assert_array_max_ulp(_pod_tensor(world, pod, "err", name, spec),
                                            xs[pod] - deq[pod], maxulp=1)
