"""The port's LM training against the JAX package's, on the CPU, for the
SSM arch, and C14: ``transformer.loss_fn`` at the reduced mamba2 (3 SSD
chunks of 32), with one update under AdamW and under Adafactor; then the
SSD's gradient at the configs' own chunk sizes, pinned both ways, and the
serving SSD bitwise as it was.  Tolerances as in
``test_torch_lm_train.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from torch_lm_util import (
    TOL,
    assert_grads_close,
    check_arch,
    check_loss,
    init_tree,
    lm_batch,
    port_value_and_grad,
    ref_value_and_grad,
    t,
)


def test_loss_grads_and_updates_match_reference():
    check_arch("mamba2-1.3b", 96)


# -- C14: the SSD's gradient at the configs' own chunk sizes ------------------

C14_CFG = ModelConfig(name="c14", family="ssm", n_layers=2, d_model=256, n_heads=1,
                      n_kv_heads=1, d_ff=0, vocab_size=512, ssm_state=16, ssm_head_dim=64,
                      ssm_chunk=128, dtype="float32", remat="none")
C14_SEQ = 256


def test_c14_reference_gradient_is_nan_at_chunk_128_and_the_ports_is_its_chunk_32():
    """The reference's SSD builds its decay as ``where(causal, exp(rel), 0)``;
    above the diagonal ``rel`` passes ~88 at chunk 128 (mamba2-1.3b's), exp
    overflows and the VJP gives NaN below the final norm.  The port masks
    ``rel`` to -inf before the exp: its gradient at chunk 128 is finite and
    equals the reference's at chunk 32 (chunking is exact), and the loss is
    the same at every chunk."""
    tree = init_tree(JT, C14_CFG)
    batch = lm_batch(C14_CFG, C14_SEQ, seed=1)
    bad = dataclasses.replace(C14_CFG, ssm_chunk=128)
    ref128 = ref_value_and_grad(JT, bad, tree, batch)
    leaves = jax.tree_util.tree_flatten_with_path(ref128[2])[0]
    nonfinite = [jax.tree_util.keystr(p) for p, v in leaves if not np.isfinite(v).all()]
    assert np.isfinite(ref128[0])
    assert "['final_ln']" not in nonfinite and "['head']" not in nonfinite
    assert "['embed']" in nonfinite and len(nonfinite) == len(leaves) - 2, nonfinite
    ref32 = ref_value_and_grad(JT, dataclasses.replace(C14_CFG, ssm_chunk=32), tree, batch)
    assert all(np.isfinite(v).all() for v in jax.tree_util.tree_leaves(ref32[2]))
    got = port_value_and_grad(T, bad, tree, batch)
    check_loss(got, ref32)
    np.testing.assert_allclose(got[0], ref128[0], **TOL)
    assert_grads_close(got[2], ref32[2])


def _ssd_before(xh, bmat, cmat, dt, a, chunk):
    """The serving SSD's intra-chunk block as it was built before C14: exp
    in place, then zero above the diagonal; the rest of ``_ssd_chunked``
    unchanged (a copy, to hold the serving numbers bitwise)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = S.chunk_size(s, chunk)
    nc = s // q
    cdt = xh.dtype
    xc = xh.reshape(b, nc, q, h, p).to(cdt)
    bc = bmat.reshape(b, nc, q, n).to(cdt)
    cc = cmat.reshape(b, nc, q, n).to(cdt)
    dtc = dt.reshape(b, nc, q, h)
    ldec = torch.cumsum(dtc * a[None, None, None, :], dim=2)
    ltot = ldec[:, :, -1, :]
    ldec_h = ldec.transpose(2, 3)
    cb = torch.einsum("bcqn,bcun->bcqu", cc, bc)
    att = ldec_h[..., :, None] - ldec_h[..., None, :]
    att.exp_()
    causal = torch.ones((q, q), dtype=torch.bool).tril()
    att.masked_fill_(~causal, 0.0)
    att.mul_(cb[:, :, None])
    att.mul_(dtc.transpose(2, 3)[:, :, :, None, :])
    y = torch.matmul(att.to(cdt), xc.permute(0, 1, 3, 2, 4)).transpose(2, 3).to(torch.float32)
    wgt = (torch.exp(ltot[:, :, None, :] - ldec) * dtc).to(cdt)
    s_c = torch.einsum("bcun,bcuhp->bchpn", bc, wgt[..., None] * xc).to(torch.float32)
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32)
    decay = torch.exp(ltot)
    hprevs = torch.empty((b, nc, h, p, n), dtype=torch.float32)
    for c in range(nc):
        hprevs[:, c] = hstate
        hstate = hstate * decay[:, c, :, None, None] + s_c[:, c]
    y_out = torch.einsum("bcqn,bchpn->bcqhp", cc, hprevs.to(cdt))
    y += (y_out * torch.exp(ldec).to(cdt)[..., None]).to(torch.float32)
    return y.reshape(b, s, h, p), hstate


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_c14_serving_ssd_is_bitwise_unchanged(dtype):
    """Serving (no gradient) builds the same numbers as before C14, bitwise,
    in f32 and bf16; the differentiable form's forward equals it bitwise
    too."""
    rng = np.random.default_rng(5)
    b, s, h, p, n = 2, 256, 4, 8, 16
    xh = t(rng.standard_normal((b, s, h, p)).astype(np.float32)).to(dtype)
    bm = t(rng.standard_normal((b, s, n)).astype(np.float32)).to(dtype)
    cm = t(rng.standard_normal((b, s, n)).astype(np.float32)).to(dtype)
    dt = t(np.log1p(np.exp(rng.standard_normal((b, s, h)) + 1.0)).astype(np.float32))
    a = -t(np.exp(rng.standard_normal(h) + 0.5).astype(np.float32))
    want_y, want_h = _ssd_before(xh, bm, cm, dt, a, 128)
    with torch.no_grad():
        y, hs = S._ssd_chunked(xh, bm, cm, dt, a, 128)
    assert torch.equal(y, want_y) and torch.equal(hs, want_h)
    gy, gh = S._ssd_chunked(xh.clone().requires_grad_(), bm, cm, dt, a, 128)
    assert torch.equal(gy.detach(), want_y) and torch.equal(gh.detach(), want_h)
