"""Attention heads that the model axis does not divide (llama4-maverick's 40
heads over the production mesh's 16-way ``model`` axis), on CPU ranks over
gloo against the port's one device: the reduced h2o-danube with 10 heads of
16 and 2 kv heads on (data=1, model=4).  Rank r of n runs heads
[r H // n, (r + 1) H // n) (2, 3, 2 and 3 here), its weights cut from the
gathered whole; decode under ``decode_32k``'s rules (the caches' sequence
over ``model``) gathers every q head padded to the longest range.

* the loss, the clip's norm and every averaged gradient block of one train
  step against one device's gradients, cut to the rank's blocks;
* prefill's logits and greedy decode's against one device's;
* each rank's prefill gathers every weight split over ``model`` whole and
  sums the attention's output over it.
"""

import numpy as np
import pytest
import torch

import torch_lm_tp_ranks as R
import torch_lm_tp_util as U
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import run_spmd
from repro_torch.launch.specs import shape_rules
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamTree

ARCH = "h2o-danube-1.8b"
OVERRIDES = {"n_heads": 10, "n_kv_heads": 2, "head_dim": 16}
MESH = (1, 4)


@pytest.fixture(scope="module")
def case():
    return U.make_inputs((ARCH,), OVERRIDES)[ARCH]


@pytest.fixture(scope="module")
def world(case):
    ranks = run_spmd(R.tp_rank, MESH, ("data", "model"), device="cpu", args=({ARCH: case},),
                     timeout=900)
    return [r[ARCH] for r in ranks]


@pytest.fixture(scope="module")
def one_device(case):
    cfg = R.tp_config(ARCH, OVERRIDES)
    rules = S.ShardingRules.make(None)
    model = ParamTree(T.params_from_numpy(case["tree"], cfg, "cpu"))
    loss, _ = T.loss_fn(model.tree(), {k: torch.from_numpy(v) for k, v in case["batch"].items()},
                        cfg, rules)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return {"loss": float(loss.detach()), "grads": grads, **U.one_device({ARCH: case})[ARCH]}


def test_the_ranges_are_uneven():
    cfg = R.tp_config(ARCH, OVERRIDES)
    ranges = []
    for rank in range(4):
        rules = shape_rules(cfg, R.shapes(U.B, U.S_TRAIN, U.MAX_SEQ)["train"],
                            U.fake_mesh(MESH, rank))
        ranges.append(T._head_range(cfg, rules))
    assert ranges == [(0, 2), (2, 5), (5, 7), (7, 10)]


def test_train_step_gradients_match_one_device(world, one_device):
    cfg = R.tp_config(ARCH, OVERRIDES)
    for rank, r in enumerate(world):
        mesh = U.fake_mesh(MESH, rank)
        rules = shape_rules(cfg, R.shapes(U.B, U.S_TRAIN, U.MAX_SEQ)["train"], mesh)
        specs = R._flat(T.param_pspecs(cfg, rules))
        tr = r["train"]
        U.close(tr["metrics"]["loss"], one_device["loss"])
        assert tr["grads"].keys() == one_device["grads"].keys()
        for name, g in tr["grads"].items():
            U.close(g, S.shard(one_device["grads"][name], mesh, specs[name]), err_msg=name)


def test_prefill_and_decode_match_one_device(world, one_device):
    for r in world:
        U.close(r["prefill"], one_device["prefill"])
        for i in range(U.STEPS):
            U.close(r["decode"][i], one_device["decode"][i])


def test_prefill_gathers_the_heads_weights_whole(world):
    """Per layer: wq and wo gathered over ``model`` (the kv projections
    too: 2 kv heads do not divide 4; no FSDP gather on a ``data`` axis of
    1), the attention's and the MLP's sums; the embedding's sum once."""
    layers = R.tp_config(ARCH, OVERRIDES).n_layers
    for r in world:
        calls = r["prefill_calls"]
        assert calls["all-gather"] == 4 * layers
        assert calls["all-reduce"] == 1 + 2 * layers
        assert np.isfinite(r["prefill"]).all()
