"""The LM's tensor-parallel layout of the MoE archs on CPU ranks over gloo,
against the JAX package's meshed run and the port's one device, as
``test_torch_lm_tp.py`` holds the dense archs (the machinery and the
checks are ``torch_lm_tp_util.py``), each on (data=2, model=2) under its
full config's rule and optimizer (Adafactor for all three):

* jamba (the default rules: ``experts -> model``): the dense dispatch of
  each rank's experts, the mamba block split over ``ff``;
* grok-1 (``experts -> None``, ``ff -> model``): every expert's MLP column-
  then row-parallel;
* llama4 (``experts -> data`` by all-to-all, ``ff -> model`` inside each
  expert).

The checks are the dense file's: parameter blocks bitwise, optimizer
state placement, loss, gradients and one update, prefill and decode, and
the caches' blocks; and ``moe._expert_block`` takes a rank's ``ff``
block.
"""

import pytest

import torch_lm_tp_ranks as R
import torch_lm_tp_util as U

ARCHS = ("jamba-v0.1-52b", "grok-1-314b", "llama4-maverick-400b-a17b")


@pytest.fixture(scope="module")
def inputs():
    return U.make_inputs(ARCHS)


@pytest.fixture(scope="module")
def ref_job(inputs, tmp_path_factory):
    return U.start_reference(inputs, tmp_path_factory.mktemp("lm_tp_moe"))


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


def test_expert_block_takes_a_ranks_ff_block():
    """Under ``ff -> model`` a rank's expert stack is its ff block of its
    experts: taken as it is; a whole stack is cut to the rank's experts."""
    import torch

    from repro_torch.models import moe as M

    cfg = R.tp_config("llama4-maverick-400b-a17b")
    mesh = U.fake_mesh((2, 2), 3)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    block = torch.zeros(e // 2, d, f // 2)
    assert M._expert_block(block, cfg, mesh, "data", n_ff=2) is block
    whole = torch.arange(e, dtype=torch.float32)[:, None, None].expand(e, f // 2, d)
    assert M._expert_block(whole, cfg, mesh, "data", n_ff=2)[:, 0, 0].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="is not a rank's"):
        M._expert_block(torch.zeros(e // 2, d, f // 4), cfg, mesh, "data", n_ff=2)
