"""The training path: the port's DLRM, AdamW and train steps on the CPU
against the JAX package's, at the reduced rm1 and rm2 configs (tables of
1,024 rows, the full MLP widths), from the same weights and the same batch.

The reference's initialized params cross over as numpy
(``params_from_numpy``); the batch is the port's produce path on the CPU,
which other tests hold bitwise to the reference's.  Tolerances, and why:

* logits and loss to rtol 1e-5: the two libraries sum the MLP products, the
  pooled embeddings and the interaction in different orders;
* gradients to rtol 1e-4, with an atol of 1e-6 of the leaf's largest
  gradient: a gradient is a sum over the batch of terms of both signs, and
  its small entries carry the rounding of the large ones;
* parameters after AdamW steps to atol lr/100, except at most a 1e-5
  share of a leaf's elements (at least one), which must still lie within
  2 lr per step: Adam divides each gradient by its own root-mean-square,
  so a gradient whose value is rounding noise still moves its parameter by
  up to about lr, in either direction;
* the moments to rtol 1e-4 beside an atol of 1e-6 of the leaf's largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_recsys as j_get_recsys
from repro.core.presto import PreStoEngine
from repro.core.spec import TransformSpec as JSpec
from repro.data.storage import PartitionedStore as JStore
from repro.data.synth import SyntheticRecSysSource as JSource
from repro.distributed.sharding import ShardingRules
from repro.models import recsys as JRS
from repro.train import adamw as j_adamw
from repro.train import clip_by_global_norm as j_clip
from repro.train import make_train_step as j_make_train_step
from repro.train import make_train_step_with_ingest as j_make_ingest
from repro.train import warmup_cosine as j_warmup_cosine
from repro.train.step import apply_updates as j_apply_updates
from repro_torch.configs.registry import get_recsys
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.models import recsys as RS
from repro_torch.train import (
    adamw,
    apply_updates,
    clip_by_global_norm,
    init_state,
    make_train_step,
    make_train_step_with_ingest,
    warmup_cosine,
)

RULES = ShardingRules.make(None)
ROWS = 128
LR = (1e-3, 2, 100)  # peak, warmup, total of the schedule
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 1e-6
PARAM_ATOL = LR[0] / 100
NOISE_SHARE = 1e-5  # of a leaf's elements: gradients that are rounding noise


def flat(tree) -> dict:
    """A nested params dict -> {"tables": .., "bottom.w0": .., ...}, the
    port's parameter names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def close(ours: dict, theirs: dict, *, rtol=0.0, atol=0.0, atol_frac=0.0, what=""):
    assert set(ours) == set(theirs)
    for name, want in theirs.items():
        got = ours[name].detach().numpy() if isinstance(ours[name], torch.Tensor) else ours[name]
        tol = atol + atol_frac * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=rtol, atol=tol, err_msg=f"{what} {name}")


def close_params(ours: dict, theirs: dict, steps: int, what="param"):
    """Parameters after `steps` AdamW steps: within PARAM_ATOL but for a
    NOISE_SHARE of each leaf, and every element within 2 lr per step."""
    assert set(ours) == set(theirs)
    for name, want in theirs.items():
        d = np.abs(ours[name].detach().numpy() - want)
        off = int((d > PARAM_ATOL).sum())
        assert off <= max(1, int(NOISE_SHARE * d.size)), f"{what} {name}: {off} of {d.size}"
        assert d.max() <= 2 * LR[0] * steps, f"{what} {name}: {d.max()}"


@pytest.fixture(scope="module", params=["rm1", "rm2"])
def setup(request):
    name = request.param
    cfg, jcfg = get_recsys(name, reduced=True), j_get_recsys(name, reduced=True)
    src = SyntheticRecSysSource(cfg.data, rows=ROWS)
    spec = TransformSpec.from_source(src)
    store = PartitionedStore(4, 2, src)
    engine = TorchPreStoEngine(spec, device="cpu")
    batches = [engine.produce_batch(store, pid) for pid in range(3)]
    jparams = JRS.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return {
        "cfg": cfg, "jcfg": jcfg, "tree": tree, "engine": engine, "store": store,
        "batches": batches, "jsrc": JSource(jcfg.data, rows=ROWS),
        "jloss": lambda p, b: JRS.loss_fn(p, b, jcfg, RULES),
        "loss": lambda m, b: RS.loss_fn(m, b, cfg),
    }


def jbatch(mb):
    return {k: jnp.asarray(v.numpy()) for k, v in mb.items()}


def model_of(s):
    return RS.params_from_numpy(s["tree"], s["cfg"], device="cpu")


def test_params_round_trip_with_reference_names(setup):
    model = model_of(setup)
    assert set(dict(model.named_parameters())) == set(flat(setup["tree"]))
    back = RS.params_to_numpy(model)
    for name, want in flat(setup["tree"]).items():
        np.testing.assert_array_equal(flat(back)[name], want)
    assert model.tables.shape == (setup["cfg"].n_tables, setup["cfg"].data.embedding_rows,
                                  setup["cfg"].emb_dim)


def test_forward_and_loss_match_reference(setup):
    model, mb = model_of(setup), setup["batches"][0]
    logits = RS.forward(model, mb, setup["cfg"]).detach().numpy()
    want = np.asarray(jax.jit(lambda p, b: JRS.forward(p, b, setup["jcfg"], RULES))(
        setup["tree"], jbatch(mb)))
    np.testing.assert_allclose(logits, want, rtol=LOSS_RTOL, atol=1e-6)
    loss, metrics = RS.loss_fn(model, mb, setup["cfg"])
    jloss, jm = jax.jit(setup["jloss"])(setup["tree"], jbatch(mb))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    # a logit within rounding of 0 could flip one prediction
    assert abs(float(metrics["accuracy"]) - float(jm["accuracy"])) <= 1 / ROWS


def test_embedding_bag_masks_lengths_and_out_of_range_ids(setup):
    """Positions at or past a row's length, and ids outside [0, R), count
    nothing; a bag with nothing valid pools to 0."""
    cfg = setup["cfg"]
    t, r, d = cfg.n_tables, 5, 3
    s, g = cfg.data.n_sparse, cfg.data.n_generated
    L = cfg.data.max_sparse_len
    tables = torch.arange(t * r * d, dtype=torch.float32).reshape(t, r, d)
    ids = torch.full((2, s, L), 1, dtype=torch.int32)
    ids[0, 0, 0] = 7  # out of range
    lengths = torch.full((2, s), min(2, L), dtype=torch.int32)
    lengths[1, 0] = 0
    one = torch.full((2, g), 2, dtype=torch.int32)
    one[1, 0] = -1
    out = RS.embedding_bag(tables, ids, lengths, one)
    torch.testing.assert_close(out[1, 1], tables[1, 1])
    torch.testing.assert_close(out[0, 0], tables[0, 1] if L > 1 else torch.zeros(d))
    torch.testing.assert_close(out[1, 0], torch.zeros(d))
    torch.testing.assert_close(out[0, s], tables[s, 2])
    torch.testing.assert_close(out[1, s], torch.zeros(d))


def test_grads_match_reference(setup):
    model, mb = model_of(setup), setup["batches"][0]
    loss, _ = RS.loss_fn(model, mb, setup["cfg"])
    loss.backward()
    jgrads = jax.jit(jax.grad(lambda p, b: setup["jloss"](p, b)[0]))(setup["tree"], jbatch(mb))
    close({k: p.grad for k, p in model.named_parameters()}, flat(jgrads),
          rtol=GRAD_RTOL, atol_frac=GRAD_ATOL_FRAC, what="grad")


def test_adamw_alone_matches_reference(setup):
    """Two updates on identical gradients (the reference's), the clip active
    on the second: parameters, moments, grad norm and lr."""
    rng = np.random.default_rng(0)
    tree = setup["tree"]
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                          tree) for scale in (1e-4, 1.0)]
    jopt = j_adamw(j_warmup_cosine(*LR))
    opt = adamw(warmup_cosine(*LR))
    jparams, jstate = tree, jopt.init(tree)
    jupdate = jax.jit(lambda g, st, p: (lambda u, st2, m: (j_apply_updates(p, u), st2, m))(
        *jopt.update(g, st, p)))
    params = {k: torch.from_numpy(v.copy()) for k, v in flat(tree).items()}
    state = opt.init(params)
    for g in grads:
        jparams, jstate, jm = jupdate(g, jstate, jparams)
        state, m = opt.update({k: torch.from_numpy(v.copy()) for k, v in flat(g).items()},
                              state, params)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 2
    close_params(params, flat(jparams), 2)
    for key in ("m", "v"):
        close(state[key], flat(jstate[key]), rtol=GRAD_RTOL, atol_frac=GRAD_ATOL_FRAC, what=key)


def _run_reference(setup, n, microbatches=1):
    jopt = j_adamw(j_warmup_cosine(*LR))
    step = jax.jit(j_make_train_step(setup["jloss"], jopt, microbatches=microbatches))
    state = {"params": jax.tree.map(jnp.asarray, setup["tree"]),
             "opt": jopt.init(setup["tree"]), "step": jnp.zeros((), jnp.int32)}
    losses = []
    for mb in setup["batches"][:n]:
        state, metrics = step(state, jbatch(mb))
        losses.append(float(metrics["loss"]))
    return state, losses


def _run_port(setup, n, microbatches=1):
    opt = adamw(warmup_cosine(*LR))
    step = make_train_step(setup["loss"], opt, microbatches=microbatches)
    state = init_state(model_of(setup), opt)
    out = []
    for mb in setup["batches"][:n]:
        state, metrics = step(state, mb)
        out.append(metrics)
    return state, out


def test_three_train_steps_match_reference(setup):
    jstate, jlosses = _run_reference(setup, 3)
    state, metrics = _run_port(setup, 3)
    np.testing.assert_allclose([float(m["loss"]) for m in metrics], jlosses, rtol=LOSS_RTOL)
    assert set(metrics[-1]) == {"loss", "accuracy", "grad_norm", "lr"}
    assert int(state["step"]) == int(jstate["step"]) == 3
    close_params(dict(state["params"].named_parameters()), flat(jstate["params"]), 3)


def test_microbatches_match_reference_and_one(setup):
    """Two microbatches: the reference's two-microbatch step, and (the loss
    being a mean over rows) the one-microbatch step's parameters."""
    jstate, _ = _run_reference(setup, 1, microbatches=2)
    state2, metrics2 = _run_port(setup, 1, microbatches=2)
    state1, _ = _run_port(setup, 1)
    params2 = dict(state2["params"].named_parameters())
    close_params(params2, flat(jstate["params"]), 1, what="microbatch param")
    close_params(params2, {k: p.detach().numpy() for k, p in state1["params"].named_parameters()},
                 1, what="one vs two")
    # the metrics are the last microbatch's, as the reference's m[-1]
    half = {k: v[ROWS // 2:] for k, v in setup["batches"][0].items()}
    want, _ = RS.loss_fn(model_of(setup), half, setup["cfg"])
    np.testing.assert_allclose(float(metrics2[0]["loss"]), float(want), rtol=LOSS_RTOL)


def test_ingest_step_matches_produce_then_step_and_reference(setup):
    """Pages in, one step: the same state as producing the batch and then
    stepping (bitwise, the same operations on the same device), and the
    reference's fused ingest program to the stated tolerances."""
    engine, store = setup["engine"], setup["store"]
    pages = engine.put_pages(engine.pin_pages(engine.stage_partition(store, 0)))
    opt = adamw(warmup_cosine(*LR))
    ingest = make_train_step_with_ingest(engine, setup["loss"], opt)
    state, metrics = ingest(init_state(model_of(setup), opt), pages)
    plain = make_train_step(setup["loss"], opt)
    state_b, metrics_b = plain(init_state(model_of(setup), opt),
                               engine.preprocess_global(pages))
    assert float(metrics["loss"]) == float(metrics_b["loss"])
    for (k, p), (_, q) in zip(state["params"].named_parameters(),
                              state_b["params"].named_parameters()):
        assert torch.equal(p, q), k
    jspec = JSpec.from_source(setup["jsrc"])
    jengine = PreStoEngine(jspec, mesh=None)
    jopt = j_adamw(j_warmup_cosine(*LR))
    jstate = {"params": jax.tree.map(jnp.asarray, setup["tree"]),
              "opt": jopt.init(setup["tree"]), "step": jnp.zeros((), jnp.int32)}
    jpages = {k: jnp.asarray(v) for k, v in jengine.stage_partition(
        JStore(4, 2, setup["jsrc"]), 0).items()}
    js, jm = jax.jit(j_make_ingest(jengine, setup["jloss"], jopt))(jstate, jpages)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    close_params(dict(state["params"].named_parameters()), flat(js["params"]), 1,
                 what="ingest param")


def test_apply_updates_matches_reference():
    """p + u for every leaf, in place, as the reference's functional form."""
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    updates = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    ours = {k: torch.from_numpy(v.copy()) for k, v in flat(params).items()}
    apply_updates(ours, {k: torch.from_numpy(v) for k, v in flat(updates).items()})
    close(ours, flat(j_apply_updates(params, updates)), what="applied")


def test_warmup_cosine_and_clip_match_reference():
    for args in (LR, (3e-4, 0, 50, 0.0), (1.0, 10, 10)):
        ours, theirs = warmup_cosine(*args), j_warmup_cosine(*args)
        for step in (0, 1, 2, 5, 9, 10, 11, 50, 99, 100, 250):
            np.testing.assert_allclose(float(ours(step)), float(theirs(step)), rtol=1e-6,
                                       atol=1e-12)
    rng = np.random.default_rng(1)
    for scale in (1e-3, 10.0):
        tree = {"a": rng.standard_normal((7, 5)).astype(np.float32) * scale,
                "b": {"c": rng.standard_normal((300,)).astype(np.float32) * scale}}
        jclipped, jgn = j_clip(tree, 1.0)
        clipped, gn = clip_by_global_norm({k: torch.from_numpy(v.copy())
                                           for k, v in flat(tree).items()}, 1.0)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        close(clipped, flat(jclipped), rtol=1e-6, what="clipped")


def test_rm_configs_and_param_counts_match_reference():
    """The model half of the configs: the schema's shapes equal the
    reference's at full width (nothing allocated) for every rm."""
    from repro.models.recsys import model_schema as j_model_schema

    for name in ("rm1", "rm2", "rm5"):
        ours, theirs = RS.model_schema(get_recsys(name)), j_model_schema(j_get_recsys(name))
        assert jax.tree.map(lambda d: d.shape, theirs) == {
            k: ({kk: vv.shape for kk, vv in v.items()} if isinstance(v, dict) else v.shape)
            for k, v in ours.items()}
    assert dataclasses.asdict(get_recsys("rm2")) == dataclasses.asdict(j_get_recsys("rm2"))
