"""The port's encoder-decoder serving path (``models.encdec``, the
seamless-m4t backbone) against the JAX package's, on the CPU.

Both run the reduced seamless from the reference's ``init_params`` carried
across by ``params_from_numpy``, on the same seeded frames.  In f32, within
rtol=atol=1e-5 (the products and softmax sums run in another order in each
library): ``encode`` over one attention block and several, the cross K/V
caches (the reference's ``examples/serve_lm.py`` computes them with a
``vmap`` over the decoder layers, the port one layer at a time), and the
logits and self-attention caches of 6 greedy ``decode_step``s, the tokens
equal.  C11: the reference's decode at ``cache_len == max_seq`` overwrites
the self cache's last slot; the port raises ``ValueError``.
"""

import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import encdec as JE
from repro.models import layers as JL
from repro_torch.configs import registry as PR
from repro_torch.examples import serve_lm
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_lm_util import J_RULES, RULES, assert_trees_close, close, t

ARCH = "seamless-m4t-medium"
B, FRAMES, STEPS = 2, 48, 6


def reference_tree(cfg):
    return jax.tree.map(np.asarray, JE.init_params(jax.random.PRNGKey(0), cfg))


def frames_of(cfg, n: int) -> np.ndarray:
    return np.random.default_rng(n).normal(size=(B, n, cfg.d_model)).astype(np.float32)


def reference_cross(params, enc_out, cfg):
    """The reference example's cross K/V: a vmap over the decoder layers."""
    s, k, hd = enc_out.shape[1], cfg.n_kv_heads, cfg.hd

    def cross_kv(lp):
        kk = (enc_out @ lp["xattn"]["wk"].astype(enc_out.dtype)).reshape(B, s, k, hd)
        vv = (enc_out @ lp["xattn"]["wv"].astype(enc_out.dtype)).reshape(B, s, k, hd)
        return kk, vv

    return jax.vmap(cross_kv)(params["dec_layers"])


@pytest.fixture(scope="module")
def served():
    """Encode, cross caches and STEPS greedy decode steps in both."""
    jcfg, cfg = JR.get_arch(ARCH).reduced, PR.get_arch(ARCH).reduced
    tree = reference_tree(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    params = E.params_from_numpy(tree, cfg, "cpu")
    frames = frames_of(cfg, FRAMES)
    max_seq = STEPS + 2

    jenc = jax.jit(lambda p, f: JE.encode(p, f, jcfg, J_RULES))(jp, jnp.asarray(frames))
    jck, jcv = reference_cross(jp, jenc, jcfg)
    zeros = jnp.zeros((jcfg.n_layers, B, max_seq, jcfg.n_kv_heads, jcfg.hd), jenc.dtype)
    jc = {"self_k": zeros, "self_v": zeros, "cross_k": jck, "cross_v": jcv}
    ref = {"enc": np.asarray(jenc), "cross": {"cross_k": np.asarray(jck),
                                              "cross_v": np.asarray(jcv)},
           "logits": [], "tokens": [], "tree": tree, "jcfg": jcfg}
    jdec = jax.jit(lambda p, x, c, n: JE.decode_step(p, x, c, n, jcfg, J_RULES))
    tok = jnp.ones((B, 1), jnp.int32)
    for i in range(STEPS):
        lg, jc = jdec(jp, tok, jc, jnp.int32(i))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        ref["logits"].append(np.asarray(lg))
        ref["tokens"].append(np.asarray(tok))
    ref["caches"] = jax.tree.map(np.asarray, jc)

    enc = E.encode(params, t(frames), cfg, RULES)
    caches = E.cross_caches(params, enc, cfg, max_seq)
    port = {"enc": enc, "cross": {k: caches[k].clone() for k in ("cross_k", "cross_v")},
            "logits": [], "tokens": [], "params": params, "cfg": cfg}
    ptok = torch.ones((B, 1), dtype=torch.int32)
    for i in range(STEPS):
        lg, caches = E.decode_step(params, ptok, caches, i, cfg, RULES)
        ptok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
        port["logits"].append(lg)
        port["tokens"].append(ptok.numpy())
    port["caches"] = caches
    return ref, port


def test_full_width_schema_equals_the_reference():
    cfg, jcfg = PR.get_arch(ARCH).config, JR.get_arch(ARCH).config
    got = L.shapes_from_schema(E.model_schema(cfg), torch.float32)
    want = JL.shapes_from_schema(JE.model_schema(jcfg), jnp.float32)
    g = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda x: tuple(x.shape), got))[0]
    w = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda x: tuple(x.shape), want))[0]
    assert g == w
    n = sum(x.numel() for x in jax.tree.leaves(got))
    assert 0.85e9 < n < 0.9e9  # ~0.88B, the vocab's 256,256 rows twice among them
    gs = jax.tree.leaves(E.param_pspecs(cfg, RULES), is_leaf=lambda x: isinstance(x, tuple))
    ws = jax.tree.leaves(JE.param_pspecs(jcfg, J_RULES), is_leaf=lambda x: x is None or
                         type(x).__name__ == "PartitionSpec")
    assert gs == [tuple(s) for s in ws]


def test_cache_spec_equals_the_reference():
    cfg, jcfg = PR.get_arch(ARCH).reduced, JR.get_arch(ARCH).reduced
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in E.cache_spec(cfg, 3, 40).items()}
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in JE.cache_spec(jcfg, 3, 40).items()}
    assert got == want


@pytest.mark.parametrize("frames", [FRAMES, 2048], ids=["one block", "several blocks"])
def test_encode_matches(frames):
    jcfg, cfg = JR.get_arch(ARCH).reduced, PR.get_arch(ARCH).reduced
    tree = reference_tree(jcfg)
    x = frames_of(cfg, frames)
    got = E.encode(E.params_from_numpy(tree, cfg, "cpu"), t(x), cfg, RULES)
    want = jax.jit(lambda p, f: JE.encode(p, f, jcfg, J_RULES))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    assert got.shape == (B, frames, cfg.d_model)
    close(got, want)


def test_encode_and_cross_caches_match(served):
    ref, port = served
    close(port["enc"], ref["enc"])
    assert_trees_close(port["cross"], ref["cross"])


def test_greedy_decode_matches(served):
    ref, port = served
    for got, want in zip(port["logits"], ref["logits"]):
        assert tuple(got.shape) == want.shape
        close(got, want)
    assert np.array_equal(np.concatenate(port["tokens"], 1), np.concatenate(ref["tokens"], 1))
    assert_trees_close(port["caches"], ref["caches"])


def test_cast_weights_give_the_numbers_of_a_cast_per_call(served):
    _, port = served
    cfg = dataclasses.replace(port["cfg"], dtype="bfloat16")
    params = port["params"]
    once = T.cast_weights(params, cfg)
    assert once["dec_layers"]["xattn"]["wk"].dtype == torch.bfloat16
    assert once["enc_ln"].dtype == torch.float32
    x = t(frames_of(cfg, FRAMES))
    a, b = E.encode(params, x, cfg, RULES), E.encode(once, x, cfg, RULES)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    ca, cb = E.cross_caches(params, a, cfg, 4), E.cross_caches(once, b, cfg, 4)
    tok = torch.ones((B, 1), dtype=torch.int32)
    la, _ = E.decode_step(params, tok, ca, 0, cfg, RULES)
    lb, _ = E.decode_step(once, tok, cb, 0, cfg, RULES)
    assert torch.equal(la, lb)


def test_c11_writing_past_the_self_cache_raises_where_the_reference_clamps(served):
    ref, port = served
    jcfg, cfg = ref["jcfg"], port["cfg"]
    max_seq = STEPS + 2
    tok = np.full((B, 1), 5, np.int32)
    jc = jax.tree.map(jnp.asarray, ref["caches"])
    _, jc2 = JE.decode_step(jax.tree.map(jnp.asarray, ref["tree"]), jnp.asarray(tok), jc,
                            jnp.int32(max_seq), jcfg, J_RULES)
    before, after = np.asarray(jc["self_k"]), np.asarray(jc2["self_k"])
    assert not np.array_equal(before[:, :, -1], after[:, :, -1])
    assert np.array_equal(before[:, :, :-1], after[:, :, :-1])
    caches = port["caches"]
    kept = {k: v.clone() for k, v in caches.items()}
    for n in (max_seq, max_seq + 3, -1):
        with pytest.raises(ValueError, match="outside the cache"):
            E.decode_step(port["params"], t(tok), caches, n, cfg, RULES)
    assert all(torch.equal(caches[k], kept[k]) for k in kept)


def test_serve_lm_example_serves_seamless_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = serve_lm.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--gen", "5"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "seamless-smoke: encoded 48 frames; decoding..."
    assert lines[1].startswith("decoded 4 steps x 2 requests in ") and "tok/s) [cpu]" in lines[1]
    assert out["tokens"].shape == (2, 5) and out["tokens"][0, 0] == 1
