"""The port's training driver (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``) on the CPU, at ``--rm rm1 --reduced
--rows 256 --steps 4 --workers 1`` (one worker, so both sessions deliver
pids 0-3 in order): from the same initial parameters (the reference's,
carried over by ``params_from_numpy`` in place of the driver's init), the
losses agree within ``test_torch_train.py``'s LOSS_RTOL (1e-5), and the
port driver's checkpoint restores in the reference, its parameters within
2 lr per step of the reference driver's own checkpoint (that file's bound;
Adam moves a parameter whose gradient is rounding noise by up to lr), and
the two restored models' losses on pid 0's batch within LOSS_RTOL.
Without ``--device`` the driver asks for CUDA and raises with no card."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_recsys as j_get_recsys
from repro.distributed.sharding import ShardingRules
from repro.launch import train as j_train
from repro.models import recsys as JRS
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import adamw as j_adamw
from repro.train import warmup_cosine as j_warmup_cosine
from repro_torch.configs.registry import get_recsys
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.launch import train as t_train
from repro_torch.models import recsys as RS

LOSS_RTOL = 1e-5
LR = 1e-3  # the drivers' default --lr
STEPS = 4
FLAGS = ["--mode", "recsys", "--rm", "rm1", "--reduced", "--rows", "256", "--steps",
         str(STEPS), "--workers", "1", "--partitions", "8"]


def _reference(ckpt_dir: str) -> dict:
    args = argparse.Namespace(
        mode="recsys", rm="rm1", arch="mamba2-1.3b", reduced=True, placement="presto",
        steps=STEPS, partitions=8, rows=256, batch=8, seq=256, lr=LR, workers=1, seed=0,
        ckpt_dir=ckpt_dir, store_root=None)
    return j_train.train_recsys(args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("driver")
    ref = _reference(str(d / "jax"))
    tree = jax.tree.map(np.asarray, JRS.init_params(jax.random.PRNGKey(0),
                                                    j_get_recsys("rm1", reduced=True)))
    with pytest.MonkeyPatch.context() as mp:
        # the driver's init draws from torch.Generator; start from the
        # reference's weights instead
        mp.setattr(RS, "init_params",
                   lambda gen, cfg, device=None: RS.params_from_numpy(tree, cfg, device))
        port = t_train.main(FLAGS + ["--device", "cpu", "--ckpt-dir", str(d / "torch")])
    return {"ref": ref, "port": port, "dir": d}


def test_losses_match_the_reference_driver(runs):
    ref, port = runs["ref"], runs["port"]
    assert port["steps"] == ref["steps"] == STEPS
    assert len(port["losses"]) == len(port["step_ms"]) == STEPS
    np.testing.assert_allclose(port["first_loss"], ref["first_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(port["last_loss"], ref["last_loss"], rtol=LOSS_RTOL)
    assert port["losses"][0] == port["first_loss"] and port["losses"][-1] == port["last_loss"]
    assert all(t > 0 for t in port["step_ms"])


def test_port_driver_checkpoint_restores_in_the_reference(runs):
    saved = runs["port"]["checkpoint"]
    assert saved["step"] == STEPS and saved["path"].endswith("step_000000004")
    assert saved["bytes"] > 0 and saved["write_s"] is not None
    jcfg = j_get_recsys("rm1", reduced=True)
    params = JRS.init_params(jax.random.PRNGKey(1), jcfg)
    target = {"params": params, "opt": j_adamw(j_warmup_cosine(LR, 20, 100)).init(params),
              "step": jnp.zeros((), jnp.int32)}
    ours = JCheckpointManager(str(runs["dir"] / "torch")).restore(target=target)
    theirs = JCheckpointManager(str(runs["dir"] / "jax")).restore(target=target)
    assert int(ours["step"]) == int(theirs["step"]) == STEPS
    assert int(ours["opt"]["count"]) == STEPS
    flat_o = jax.tree_util.tree_leaves(ours["params"])
    flat_t = jax.tree_util.tree_leaves(theirs["params"])
    assert len(flat_o) == len(flat_t)
    for o, t in zip(flat_o, flat_t):
        assert float(jnp.max(jnp.abs(o - t))) <= 2 * LR * STEPS
    # the two restored models score pid 0's batch alike
    cfg = get_recsys("rm1", reduced=True)
    src = SyntheticRecSysSource(cfg.data, rows=256)
    mb = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu").produce_batch(
        PartitionedStore(8, 8, src), 0)
    jmb = {k: jnp.asarray(v.numpy()) for k, v in mb.items()}
    loss = jax.jit(lambda p: JRS.loss_fn(p, jmb, jcfg, ShardingRules.make(None))[0])
    np.testing.assert_allclose(float(loss(ours["params"])), float(loss(theirs["params"])),
                               rtol=LOSS_RTOL)


def test_driver_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(FLAGS)


def test_lm_mode_is_not_offered():
    with pytest.raises(SystemExit):
        t_train.main(["--mode", "lm", "--device", "cpu"])
