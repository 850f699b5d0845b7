"""The port's training forward against its own serving path, on the CPU:
the mirror of ``tests/test_models_consistency.py::test_decode_matches_forward``
for its seven configs (dense full, swa, chunked, local_global, ssm, a
hybrid with MoE, top-1 MoE).  ``_backbone`` and ``_logits_head`` give the
logits of every position; a prefill of the first half and greedy decode of
the rest against the caches reproduce them within the reference test's
2e-2.  The weights are the reference's ``init_params``, carried across by
``params_from_numpy``; the port alone runs."""

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from torch_lm_util import RULES, t

KW = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32",
          remat="none")
SSM = dict(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
CASES = {
    "dense_full": dict(family="dense", n_layers=2),
    "dense_swa": dict(family="dense", n_layers=2, attention="swa", window=16),
    "chunked": dict(family="dense", n_layers=4, attention="chunked", chunk_size=16),
    "local_global": dict(family="dense", n_layers=6, attention="local_global",
                         local_global_period=6, window=16),
    "ssm": dict(family="ssm", n_layers=2, n_heads=1, n_kv_heads=1, d_ff=0, **SSM),
    "hybrid_moe": dict(family="hybrid", n_layers=8, n_experts=4, top_k=2, moe_period=2,
                       attn_period=8, capacity_factor=4.0, **SSM),
    "moe_top1": dict(family="moe", n_layers=2, n_kv_heads=4, n_experts=4, top_k=1,
                     capacity_factor=4.0),
}


def config(case, cls):
    return cls(name=case, **{**KW, **CASES[case]})


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_forward(case):
    from repro.models.config import ModelConfig as JModelConfig

    cfg = config(case, ModelConfig)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                  config(case, JModelConfig)))
    params = T.params_from_numpy(tree, cfg, "cpu")
    s = 64
    toks = t(np.random.default_rng(0).integers(1, cfg.vocab_size, (2, s)).astype(np.int32))
    with torch.no_grad():
        x = T._embed_tokens(params, toks, cfg, RULES)
        pos = torch.arange(s).expand(2, s)
        h, aux = T._backbone(params, x, pos, cfg, RULES)
        full = T._logits_head(params, h, cfg, RULES)
        assert (float(aux) > 0) == bool(cfg.n_experts)
        s0 = s // 2
        lg, caches = T.prefill(params, toks[:, :s0], cfg, RULES, s)
        errs = [float((lg[:, 0] - full[:, s0 - 1]).abs().max())]
        for i in range(s0, s):
            lg2, caches = T.decode_step(params, toks[:, i:i + 1], caches, i, cfg, RULES)
            errs.append(float((lg2[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 2e-2, (case, max(errs))
