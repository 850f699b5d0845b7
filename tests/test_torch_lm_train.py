"""The port's LM training forward and backward against the JAX package's,
on the CPU, for the dense archs: ``transformer.loss_fn`` (``_backbone``,
``chunked_xent``, remat) at the reduced h2o-danube, gemma-7b, glm4 and
gemma3, with one update under AdamW and under Adafactor; segment ids;
remat "none", "dots" and "full" giving the same numbers; and
``chunked_xent`` over several blocks.  The other archs are in
``test_torch_lm_train_frontends.py`` (VLM, enc-dec),
``test_torch_lm_train_moe.py`` and ``test_torch_lm_train_ssm.py`` (with
C14).

Both packages start from the reference's ``init_params`` (carried across by
``params_from_numpy``) and the same seeded batch.  Tolerances, f32:

* loss and metrics within rtol=atol=1e-5 (``TOL``): sums in another order;
* gradient leaves within rtol=1e-4, atol=1e-5 (``GRAD_TOL``): the
  backward's sums over batch, sequence and blocks run in another order in
  each library, and relative error grows where a leaf's entries cancel;
* parameters after one update within 1e-5, both packages' optimizers fed
  the reference's gradients (AdamW's first step is g / (|g| + eps), which
  the gradients' own tolerance would move by more than 1e-5 where an entry
  is near eps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import transformer as JT
from repro_torch.models import transformer as T
from torch_lm_util import (
    GRAD_TOL,
    J_RULES,
    RULES,
    TOL,
    assert_grads_close,
    both_configs,
    check_arch,
    check_loss,
    check_remat_modes,
    init_tree,
    lm_batch,
    port_value_and_grad,
    ref_value_and_grad,
    t,
)

SEQ = 96  # past h2o's window (64) and gemma3's (32)
ARCHS = ("h2o-danube-1.8b", "gemma-7b", "glm4-9b", "gemma3-12b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_updates_match_reference(arch):
    check_arch(arch, SEQ)


def test_segment_ids_match_reference():
    jcfg, cfg = both_configs("h2o-danube-1.8b")
    tree = init_tree(JT, jcfg)
    batch = lm_batch(cfg, SEQ, seed=3, segments=True)
    assert len(np.unique(batch["segment_ids"])) > 1  # several documents packed
    ref = ref_value_and_grad(JT, jcfg, tree, batch)
    got = port_value_and_grad(T, cfg, tree, batch)
    check_loss(got, ref)
    assert_grads_close(got[2], ref[2])
    plain = port_value_and_grad(T, cfg, tree, {k: v for k, v in batch.items()
                                              if k != "segment_ids"})
    assert abs(plain[0] - got[0]) > 1e-4  # the segments change the loss


def test_remat_modes_give_the_same_numbers():
    """Remat moves memory, not numbers ("none" is held to the reference by
    ``test_loss_grads_and_updates_match_reference``)."""
    check_remat_modes("h2o-danube-1.8b", SEQ)


def test_chunked_xent_blocks_match_reference():
    """Several sequence blocks (the largest divisor of S up to the block),
    the padded-vocab mask and a partial mask, value and gradient against
    the reference."""
    jcfg, cfg = both_configs("h2o-danube-1.8b")
    cfg = dataclasses.replace(cfg, vocab_size=500)  # padded to 512: 12 masked rows
    jcfg = dataclasses.replace(jcfg, vocab_size=500)
    tree = init_tree(JT, jcfg)
    jtree = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 96, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 96)).astype(np.int32)
    mask = (rng.random((2, 96)) < 0.7).astype(np.float32)
    for block in (96, 40, 7):  # one block; 32 (3 blocks); 6 (16 blocks)
        ref = jax.value_and_grad(lambda x: JT.chunked_xent(
            jtree, x, jnp.asarray(labels), jnp.asarray(mask), jcfg, J_RULES, block))
        want, jg = ref(jnp.asarray(h))
        ht = t(h).requires_grad_()
        got = T.chunked_xent(T.params_from_numpy(tree, cfg, "cpu"), ht, t(labels), t(mask),
                             cfg, RULES, block)
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
        got.backward()
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jg), **GRAD_TOL)
