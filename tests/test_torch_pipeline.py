"""The port's training pipeline: a service session feeding the DLRM.

``TrainingPipeline.run_session`` drains a port service session into the
port's train step (the paper's Fig. 9 loop) on the CPU, from the reference's
initial weights carried across by ``params_from_numpy``; its losses and
parameters are held to the reference pipeline's over the same partitions,
to the tolerances of ``tests/test_torch_train.py`` (losses rtol 1e-5;
parameters atol lr/100 but for a 1e-5 share of each leaf, every element
within 2 lr per step).  Also mirrors ``tests/test_system.py``'s pipeline
tests: the deprecated ``run`` shim (which warns), straggler re-issue under
training, provisioning, and the placement groups of
``provision_by_placement``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_recsys as j_get_recsys
from repro.core.pipeline import TrainingPipeline as JPipeline
from repro.core.presto import PreStoEngine
from repro.core.service import JobSpec as JJobSpec
from repro.core.service import PreprocessingService as JService
from repro.core.spec import TransformSpec as JSpec
from repro.data.storage import PartitionedStore as JStore
from repro.data.synth import SyntheticRecSysSource as JSource
from repro.distributed.sharding import ShardingRules
from repro.models import recsys as JRS
from repro.train import adamw as j_adamw
from repro.train import make_train_step as j_make_train_step
from repro.train import warmup_cosine as j_warmup_cosine
from repro_torch.configs.registry import get_recsys
from repro_torch.core.pipeline import PipelineStats, TrainingPipeline
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.service import JobSpec, PreprocessingService
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.models import recsys as RS
from repro_torch.train import adamw, init_state, make_train_step, warmup_cosine
from torch_service_util import bounded

RULES = ShardingRules.make(None)
ROWS = 128
N_PARTS = 8
LR = (1e-3, 2, 100)  # peak, warmup, total of the schedule
LOSS_RTOL = 1e-5
PARAM_ATOL = LR[0] / 100
NOISE_SHARE = 1e-5  # of a leaf's elements: gradients that are rounding noise


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = get_recsys("rm1", reduced=True), j_get_recsys("rm1", reduced=True)
    src, jsrc = SyntheticRecSysSource(cfg.data, rows=ROWS), JSource(jcfg.data, rows=ROWS)
    tree = jax.tree.map(np.asarray, JRS.init_params(jax.random.PRNGKey(0), jcfg))
    return {
        "cfg": cfg, "jcfg": jcfg, "tree": tree,
        "spec": TransformSpec.from_source(src), "jspec": JSpec.from_source(jsrc),
        "store": PartitionedStore(N_PARTS, num_devices=4, source=src),
        "jstore": JStore(N_PARTS, num_devices=4, source=jsrc),
        "loss": lambda m, b: RS.loss_fn(m, b, cfg),
        "jloss": lambda p, b: JRS.loss_fn(p, b, jcfg, RULES),
    }


def port_state(setup):
    opt = adamw(warmup_cosine(*LR))
    model = RS.params_from_numpy(setup["tree"], setup["cfg"], device="cpu")
    return init_state(model, opt), make_train_step(setup["loss"], opt)


def reference_state(setup):
    jopt = j_adamw(j_warmup_cosine(*LR))
    state = {"params": jax.tree.map(jnp.asarray, setup["tree"]),
             "opt": jopt.init(setup["tree"]), "step": jnp.zeros((), jnp.int32)}
    return state, jax.jit(j_make_train_step(setup["jloss"], jopt))


def flat(tree) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def close_params(model, theirs: dict, steps: int) -> None:
    ours = dict(model.named_parameters())
    assert set(ours) == set(theirs)
    for name, want in theirs.items():
        d = np.abs(ours[name].detach().numpy() - want)
        off = int((d > PARAM_ATOL).sum())
        assert off <= max(1, int(NOISE_SHARE * d.size)), f"{name}: {off} of {d.size}"
        assert d.max() <= 2 * LR[0] * steps, f"{name}: {d.max()}"


def test_run_session_trains_like_the_reference(setup):
    """Two workers feed 4 steps from a session, in claim order: the losses
    and parameters are the reference pipeline's over the same partitions."""
    engine = TorchPreStoEngine(setup["spec"], device="cpu")
    state, step = port_state(setup)
    with PreprocessingService(num_workers=2) as svc:
        session = svc.submit(JobSpec(name="train", partitions=range(4), engine=engine,
                                     store=setup["store"], units=2))
        state, stats, metrics = bounded(TrainingPipeline(train_step=step).run_session,
                                        state, session)
    jstate, jstep = reference_state(setup)
    with JService(num_workers=2) as jsvc:
        jsession = jsvc.submit(JJobSpec(name="train", partitions=range(4),
                                        engine=PreStoEngine(setup["jspec"]),
                                        store=setup["jstore"], units=2))
        jstate, jstats, jmetrics = JPipeline(train_step=jstep).run_session(jstate, jsession)

    assert isinstance(stats, PipelineStats)
    assert stats.steps == jstats.steps == 4 and session.stats().done
    assert all(isinstance(v, float) for m in metrics for v in m.values())
    assert set(metrics[-1]) == set(jmetrics[-1]) == {"loss", "accuracy", "grad_norm", "lr"}
    losses = [m["loss"] for m in metrics]
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, [m["loss"] for m in jmetrics], rtol=LOSS_RTOL)
    assert int(state["step"]) == int(jstate["step"]) == 4
    close_params(state["params"], flat(jstate["params"]), 4)
    assert 0.0 < stats.utilization <= 1.0
    assert stats.starved_time_s >= 0.0 and stats.reissues == 0
    assert stats.train_time_s + stats.starved_time_s <= stats.wall_time_s


def test_run_session_stops_at_max_steps_and_cancels_the_rest(setup):
    engine = TorchPreStoEngine(setup["spec"], device="cpu")
    state, step = port_state(setup)
    with PreprocessingService(num_workers=2) as svc:
        session = svc.submit(JobSpec(name="short", partitions=range(N_PARTS),
                                     engine=engine, store=setup["store"]))
        _state, stats, metrics = bounded(TrainingPipeline(train_step=step).run_session,
                                         state, session, max_steps=3)
    assert stats.steps == len(metrics) == 3
    assert session.cancelled and not session.done  # its units went back


def test_deprecated_run_warns_and_trains(setup):
    engine = TorchPreStoEngine(setup["spec"], device="cpu")
    state, step = port_state(setup)
    pipe = TrainingPipeline(engine, setup["store"], step, num_workers=2)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        _state, stats, metrics = bounded(pipe.run, state, range(N_PARTS), max_steps=6)
    assert stats.steps == 6
    assert 0.0 < stats.utilization <= 1.0
    assert np.isfinite(metrics[-1]["loss"])
    with pytest.raises(ValueError, match="run_session"):
        TrainingPipeline(train_step=step).run(state, range(2))


def test_straggler_reissue_preserves_results(setup):
    """Duplicate produces (straggler backups) must not corrupt training:
    partitions are deterministic, winner takes first."""
    engine = TorchPreStoEngine(setup["spec"], device="cpu")
    state, step = port_state(setup)
    pipe = TrainingPipeline(engine, setup["store"], step, num_workers=3,
                            straggler_timeout=0.0)  # aggressive re-issue
    with pytest.warns(DeprecationWarning):
        _state, stats, metrics = bounded(pipe.run, state, range(N_PARTS), max_steps=N_PARTS)
    assert stats.steps == N_PARTS
    assert np.isfinite(metrics[-1]["loss"])


def test_provisioning_plan(setup):
    engine = TorchPreStoEngine(setup["spec"], device="cpu")
    state, step = port_state(setup)
    plan = TrainingPipeline(engine, setup["store"], step).provision(state)
    assert plan.workers_required >= 1
    assert plan.workers_required == -(-plan.train_throughput // plan.worker_throughput)


@pytest.mark.parametrize("placement", ["presto", "disagg", {"gen": "host"}],
                         ids=["presto", "disagg", "hybrid-gen-host"])
def test_provision_by_placement_groups_equal_reference(setup, placement):
    """The placement groups the probe is provisioned by are the reference's
    for the same placement, and every group gets at least one unit."""
    engine = TorchPreStoEngine(setup["spec"], placement=placement, device="cpu")
    state, step = port_state(setup)
    prov = TrainingPipeline(engine, setup["store"], step).provision_by_placement(state)
    jengine = PreStoEngine(setup["jspec"], placement=placement)
    jstate, jstep = reference_state(setup)
    jprov = JPipeline(jengine, setup["jstore"], jstep).provision_by_placement(jstate)
    assert sorted(prov.group_units) == sorted(jprov.group_units)
    assert sorted(prov.group_throughput) == sorted(jprov.group_throughput)
    assert all(u >= 1 for u in prov.group_units.values())
    assert all(p > 0 for p in prov.group_throughput.values()) and prov.train_throughput > 0
    assert prov.total_units == sum(prov.group_units.values())


def test_metrics_are_read_as_floats_once_per_step(setup, monkeypatch):
    """Each metric tensor crosses to a float inside the timed step: the
    session's batches reach the step as tensors, the log holds floats."""
    engine = TorchPreStoEngine(setup["spec"], device="cpu")
    state, step = port_state(setup)
    seen = []

    def spy(state, mb):
        seen.append({k: type(v) for k, v in mb.items()})
        return step(state, mb)

    with PreprocessingService(num_workers=1) as svc:
        session = svc.submit(JobSpec(name="spy", partitions=range(2), engine=engine,
                                     store=setup["store"]))
        _state, stats, metrics = bounded(TrainingPipeline(train_step=spy).run_session,
                                         state, session)
    assert stats.steps == 2 and len(seen) == 2
    assert all(t is torch.Tensor for s in seen for t in s.values())
    assert all(type(v) is float for m in metrics for v in m.values())
