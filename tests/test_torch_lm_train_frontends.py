"""The port's LM training against the JAX package's, on the CPU, for the
archs with a stubbed frontend: the reduced internvl2 (prefix embeddings
ahead of the tokens) and seamless-m4t-medium (``encdec.loss_fn``: frames
into the encoder), with one update under AdamW and under Adafactor; the
mirror of the reference's ``test_vlm_prefix_changes_loss``; remat modes at
the enc-dec.  Tolerances as in ``test_torch_lm_train.py``.
"""

import pytest

from repro.models import transformer as JT
from repro_torch.models import transformer as T
from torch_lm_util import (
    assert_grads_close,
    both_configs,
    check_arch,
    check_loss,
    check_remat_modes,
    init_tree,
    lm_batch,
    port_value_and_grad,
    ref_value_and_grad,
)

SEQ = 96


@pytest.mark.parametrize("arch", ["internvl2-76b", "seamless-m4t-medium"])
def test_loss_grads_and_updates_match_reference(arch):
    check_arch(arch, SEQ)


def test_vlm_prefix_changes_loss_and_matches_reference():
    """The mirror of the reference's ``test_vlm_prefix_changes_loss``, held
    to the reference with segment ids over the prefix too."""
    jcfg, cfg = both_configs("internvl2-76b")
    tree = init_tree(JT, jcfg)
    batch = lm_batch(cfg, SEQ, segments=True, prefix=True)
    ref = ref_value_and_grad(JT, jcfg, tree, batch)
    got = port_value_and_grad(T, cfg, tree, batch)
    check_loss(got, ref)
    assert_grads_close(got[2], ref[2])
    batch2 = dict(batch, prefix_embeds=batch["prefix_embeds"] * 2)
    other = port_value_and_grad(T, cfg, tree, batch2)
    assert abs(other[0] - got[0]) > 1e-5


def test_remat_modes_give_the_same_numbers():
    """The reference checkpoints every enc-dec layer whenever remat is not
    "none"; the numbers stay."""
    check_remat_modes("seamless-m4t-medium", SEQ)
