"""The port's ElasticTrainer on the CPU, mirroring
``tests/test_train.py::test_elastic_failure_restart_continues`` with the
reduced rm1 DLRM: a failure at step 5 leaves the checkpoint of step 4, a new
incarnation restores it and finishes at step 6, and its parameters match a
run that never failed within the reference test's 1e-5.  The failed
incarnation's state is freed once the exception is caught: its traceback
pins nothing (on the card that state is tens of GiB)."""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_recsys
from repro_torch.core.ctrlplane import SimulatedFailure
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.models import recsys as RS
from repro_torch.train import (
    CheckpointManager,
    ElasticTrainer,
    adamw,
    init_state,
    make_train_step,
    warmup_cosine,
)

ROWS = 128
TOL = 1e-5  # the reference test's bound on max |resumed - straight|


@pytest.fixture(scope="module")
def setup():
    cfg = get_recsys("rm1", reduced=True)
    src = SyntheticRecSysSource(cfg.data, rows=ROWS)
    engine = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    batch = engine.produce_batch(PartitionedStore(1, 1, src), 0)
    tree = RS.params_to_numpy(RS.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    opt = adamw(warmup_cosine(1e-3, 2, 100))
    step = make_train_step(lambda m, b: RS.loss_fn(m, b, cfg), opt)
    return {"cfg": cfg, "batch": batch, "tree": tree, "opt": opt, "step": step}


def test_elastic_failure_restart_continues(setup, tmp_path):
    made = []

    def make_state(device):
        state = init_state(RS.params_from_numpy(setup["tree"], setup["cfg"], device),
                           setup["opt"])
        made.append(weakref.ref(state["params"]))
        return state

    ck = CheckpointManager(str(tmp_path), async_save=False)
    trainer = ElasticTrainer(
        make_device=lambda: torch.device("cpu"),
        make_state=make_state,
        make_step=lambda device: setup["step"],
        ckpt=ck,
        checkpoint_every=2,
    )
    batches = lambda: ((i, setup["batch"]) for i in range(6))  # noqa: E731
    with pytest.raises(RuntimeError, match="simulated failure") as err:
        trainer.run(batches(), max_steps=6, fail_at=5)
    assert isinstance(err.value, SimulatedFailure)
    assert ck.latest_step() == 4  # checkpointed before the crash
    gc.collect()
    assert made[0]() is None  # the traceback in `err` pins no state
    # new incarnation restores and finishes; replayed steps are skipped
    state, metrics = trainer.run(batches(), max_steps=6)
    assert int(state["step"]) == 6 and int(state["opt"]["count"]) == 6
    assert ck.latest_step() == 6 and np.isfinite(float(metrics["loss"]))
    # straight-through run (no failure) matches the restarted run
    straight = make_state(torch.device("cpu"))
    for _ in range(6):
        straight, _ = setup["step"](straight, setup["batch"])
    got, want = RS.params_to_numpy(state["params"]), RS.params_to_numpy(straight["params"])
    worst = 0.0
    for group, leaves in want.items():
        for name, w in (leaves.items() if isinstance(leaves, dict) else [("", leaves)]):
            g = got[group][name] if name else got[group]
            worst = max(worst, float(np.abs(g - w).max()))
    assert worst < TOL


def test_bootstrap_without_a_checkpoint_keeps_the_fresh_state(setup, tmp_path):
    fresh = {}

    def make_state(device):
        fresh["state"] = init_state(
            RS.params_from_numpy(setup["tree"], setup["cfg"], device), setup["opt"])
        return fresh["state"]

    trainer = ElasticTrainer(lambda: torch.device("cpu"), make_state,
                             lambda device: setup["step"], CheckpointManager(str(tmp_path)))
    device, state, step_fn = trainer.bootstrap()
    assert device.type == "cpu" and state is fresh["state"] and step_fn is setup["step"]
    assert int(state["step"]) == 0
