"""The port's LM training forward and backward against the JAX package's,
on the CPU, for the MoE and hybrid archs: ``transformer.loss_fn`` at the
reduced jamba, grok-1 and llama4 (the MoE aux loss in the loss, non-zero,
and its gradient through the router), with one update under AdamW and
under Adafactor; remat "none", "dots" and "full" giving the same numbers
at the hybrid.  Tolerances as in ``test_torch_lm_train.py``.
"""

import pytest

from torch_lm_util import check_arch, check_remat_modes

SEQ = 96  # past llama4's chunk (32): 3 SSD chunks of 32 at jamba
ARCHS = ("jamba-v0.1-52b", "grok-1-314b", "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_updates_match_reference(arch):
    check_arch(arch, SEQ)


def test_remat_modes_give_the_same_numbers():
    check_remat_modes("jamba-v0.1-52b", SEQ)
