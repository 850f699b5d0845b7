"""The LM's tensor-parallel and FSDP layout on CPU ranks over gloo, against
the JAX package jitted with ``build_*_cell``'s ``in_shardings`` on fake
devices and against the port's one device: the dense archs (reduced
h2o-danube, mamba2 and seamless on (data=2, model=2); gemma3 on (data=1,
model=4), the reference's ``_kv_axis`` replicated branch).  The MoE archs
are ``test_torch_lm_tp_moe.py``; the machinery and the checks are
``torch_lm_tp_util.py``.

* every rank's block of every parameter equals the reference's
  ``addressable_shards`` of the same device bitwise, and the port's
  ``block_index`` of every parameter and optimizer-state leaf is the
  shard's ``index``;
* the loss, every averaged gradient block, and the blocks of one update
  (parameters and optimizer state, in the reference's layout) against the
  reference's meshed step;
* prefill (the enc-dec's encoder output) and greedy decode under a decode
  shape's rules (``kv_seq -> model``, caches resharded from the prefill's)
  against the reference's meshed run and the port's one device, and the
  caches' blocks under both rules;
* the collectives of a prefill: one gather per FSDP weight read, one psum
  per row-parallel product;
* a global-format checkpoint of h2o's state after the step, saved from
  (2, 2), restores on one device bitwise the ranks' blocks put together;
* the dry run's trace of rank 0's h2o train and decode cells on a mesh
  with no world counts the collectives the world's rank 0 made.
"""

import pytest
import torch

import torch_lm_tp_ranks as R
import torch_lm_tp_util as U
from repro_torch.distributed.comm import KINDS
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs, trace_cost
from repro_torch.launch.mesh import Mesh

ARCHS = ("h2o-danube-1.8b", "mamba2-1.3b", "seamless-m4t-medium", U.KV_ARCH)


CKPT_ARCH = "h2o-danube-1.8b"


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("lm_tp_ckpt"))


@pytest.fixture(scope="module")
def inputs(ckpt_dir):
    cases = U.make_inputs(ARCHS)
    cases[CKPT_ARCH]["ckpt"] = ckpt_dir
    return cases


@pytest.fixture(scope="module")
def ref_job(inputs, tmp_path_factory):
    return U.start_reference(inputs, tmp_path_factory.mktemp("lm_tp"))


@pytest.fixture(scope="module")
def world(inputs, ref_job):
    return U.run_worlds(inputs)


@pytest.fixture(scope="module")
def ref(ref_job, world):
    return U.finish_reference(ref_job)


@pytest.fixture(scope="module")
def one_device(inputs):
    return U.one_device(inputs)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_blocks_equal_the_references_shards_bitwise(world, ref, arch):
    U.check_parameter_blocks(world, ref, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_state_blocks_lie_where_the_references_do(world, ref, arch):
    U.check_optimizer_state_blocks(world, ref, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_and_one_update_match_the_references_meshed_step(world, ref, arch):
    """The loss and the clip's norm, every averaged gradient block, and the
    blocks of the updated parameters and optimizer state.  The state holds
    the gradients' squares (and AdamW's their 0.1 share), summed on each
    side in another order: rtol 1e-4 there, atol 1e-5 of the leaf's
    largest magnitude."""
    U.check_train(world, ref, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference_and_one_device(world, ref, one_device, arch):
    U.check_serving(world, ref, one_device, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_blocks_follow_the_prefill_and_decode_rules(world, ref, arch):
    """The prefill's caches are the rank's blocks of the reference's under
    the prefill rules; resharded, its blocks under the decode rules."""
    U.check_caches(world, ref, arch)


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b", U.KV_ARCH))
def test_prefill_gathers_each_fsdp_weight_once_and_sums_each_row_parallel_product(world, arch):
    """h2o on (2, 2): 7 FSDP weights a layer and the head gathered over
    ``data``; the embedding's, attention's and MLP's sums over ``model``.
    gemma3 on (1, 4): no FSDP gather; the kv projections gathered over
    ``model`` (2 a layer); the same sums."""
    layers = R.tp_config(arch).n_layers
    gathers = 2 * layers if arch == U.KV_ARCH else 7 * layers + 1
    for r in world[arch]:
        calls = r["prefill_calls"]
        assert calls["all-gather"] == gathers
        assert calls["all-reduce"] == 1 + 2 * layers
        assert calls["all-to-all"] == calls["collective-permute"] == 0


def test_a_meshed_checkpoint_restores_on_one_device_bitwise(world, ckpt_dir):
    """The state after the step, saved by the (2, 2) ranks: its parameters
    and optimizer state restore on one device into the global arrays that
    the ranks' blocks make up, bit for bit."""
    U.check_checkpoint(world, ckpt_dir, CKPT_ARCH)


@pytest.mark.parametrize("arch", ("h2o-danube-1.8b",))
def test_a_dry_rank_counts_the_collectives_of_the_worlds_rank_0(world, arch):
    """Rank 0's cells on a (2, 2) mesh with no world behind it
    (``launch.specs.build_*_cell``, traced on meta tensors by
    ``launch.trace_cost``): its train step and each decode step make the
    calls, and move the bytes, by kind that the gloo world's rank 0
    counted on real tensors."""
    cfg = R.tp_config(arch)
    mesh = Mesh(dict(zip(("data", "model"), U.mesh_of(arch))), 0, torch.device("meta"), "none")
    cells = R.shapes(U.B, U.S_TRAIN, U.MAX_SEQ)
    got = world[arch][0]

    def dry(kind, cache_len=None):
        build = specs.build_train_cell if kind == "train" else specs.build_decode_cell
        spec = build(cfg, cells[kind], mesh)
        args = D.meta_args(spec, cells[kind])
        if cache_len is not None:
            args[3] = cache_len
        cost = trace_cost.analyze(spec.fn, args, counter=mesh.counter)
        return ({k: cost.coll_calls[k] for k in KINDS},
                {k: int(cost.coll_breakdown[k]) for k in KINDS})

    assert dry("train") == (got["train"]["calls"], got["train"]["bytes"])
    for i, comm_i in enumerate(got["decode_comm"]):
        assert dry("decode", U.PROMPT + i) == tuple(comm_i)
