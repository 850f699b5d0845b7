"""The port's LM serving layers, its dense archs and ``launch.serve``
against the JAX package's, on the CPU (the MoE, SSM and hybrid archs:
``test_torch_lm_ssm_moe.py``; the encoder-decoder: ``test_torch_lm_encdec.py``).

The port and ``repro.models`` run on the same numpy weights (the
reference's ``init_params`` carried across by ``params_from_numpy``) and
the same seeded prompts.  Tolerances, and why:

* layers (``rmsnorm``, ``apply_rope``, ``blockwise_attention`` over full,
  swa and chunked patterns with and without segment ids, one block and
  several; ``decode_attention`` with ``cache_len`` past the window):
  rtol=atol=1e-5 in f32; the products and exponentials sum in another
  order in each library;
* the reduced h2o-danube, gemma-7b, glm4-9b and gemma3-12b configs in f32:
  prefill logits, the caches and 4 greedy decode steps within
  rtol=atol=1e-5, every greedy token equal;
* the reduced h2o-danube in bf16: prefill and decode logits within
  atol=0.05, about three bf16 ulps at the logits' size (they reach about
  3.4, where one ulp is 0.0156; the two libraries round the products and
  the residual stream at different points: one ulp at most over 3 seeds
  when written), greedy tokens equal where the reference's top two logits
  are more than 0.05 apart; the port's ``cast_weights`` copy gives bitwise
  the numbers of its cast on every call;
* a vocab of 500, padded to 512: the padded logits are -1e30 in both;
* C11: the reference's decode at ``cache_len == max_seq`` overwrites the
  cache's last slot; the port raises ``ValueError``;
* the CLI serves every decoder-only arch and refuses the encoder-decoder
  with the reference's message.
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
from repro.models import config as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import registry as PR
from repro_torch.launch import serve
from repro_torch.models import config as PC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_lm_util import B, J_RULES, PROMPT, RULES, TOL, close, run_both, t

BF16_ATOL = 0.05
DENSE = ("h2o-danube-1.8b", "gemma-7b", "glm4-9b", "gemma3-12b")
MOE_SSM = ("jamba-v0.1-52b", "mamba2-1.3b", "grok-1-314b", "llama4-maverick-400b-a17b")


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_arch_configs_equal_the_reference(arch):
    got, want = PR.get_arch(arch), JR.get_arch(arch)
    for field in ("config", "reduced"):
        g, w = getattr(got, field), getattr(want, field)
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert [dataclasses.asdict(s) for s in g.period()] == \
            [dataclasses.asdict(s) for s in w.period()]
        assert (g.hd, g.padded_vocab, g.n_periods) == (w.hd, w.padded_vocab, w.n_periods)
    assert got.skip_shapes == want.skip_shapes and PR.list_arch_ids() == JR.list_arch_ids()
    assert {k: dataclasses.asdict(v) for k, v in PC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}


@pytest.mark.parametrize("arch", DENSE + ("internvl2-76b",) + MOE_SSM)
def test_full_width_schema_equals_the_reference(arch):
    """The parameter tree, shapes and specs at full width (meta tensors)."""
    cfg, jcfg = PR.get_arch(arch).config, JR.get_arch(arch).config
    got = L.shapes_from_schema(T.model_schema(cfg), torch.float32)
    want = JL.shapes_from_schema(JT.model_schema(jcfg), jnp.float32)
    g = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda x: tuple(x.shape), got))[0]
    w = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda x: tuple(x.shape), want))[0]
    assert g == w
    gs = jax.tree.leaves(T.param_pspecs(cfg, RULES), is_leaf=lambda x: isinstance(x, tuple))
    ws = jax.tree.leaves(JT.param_pspecs(jcfg, J_RULES), is_leaf=lambda x: x is None or
                         type(x).__name__ == "PartitionSpec")
    assert gs == [tuple(s) for s in ws]


def test_h2o_danube_full_width_is_1_8b_parameters():
    shapes = L.shapes_from_schema(T.model_schema(PR.get_arch("h2o-danube-1.8b").config),
                                  torch.float32)
    assert sum(x.numel() for x in jax.tree.leaves(shapes)) == 1_831_201_280


@pytest.mark.parametrize("arch", MOE_SSM)
def test_moe_and_ssm_archs_serve_through_the_cli(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                          "--gen", "3"])
    lines = buf.getvalue().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith(f"{PR.get_arch(arch).reduced.name}: prefill(2x64) ")
    assert "decode 2 steps" in lines[0] and lines[0].endswith("[cpu]")
    assert lines[1].startswith("sample token ids: [")
    assert out["tokens"].shape == (2, 3)


def test_encdec_is_refused_naming_serve_lm():
    with pytest.raises(ValueError, match="use examples/serve_lm.py for enc-dec serving"):
        serve.main(["--arch", "seamless-m4t-medium", "--reduced", "--device", "cpu", "--gen", "2"])


# ---------------------------------------------------------------------------
# layers


@pytest.mark.parametrize("d", [64, 80])
def test_rmsnorm(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 5, d)).astype(np.float32) * 3
    w = rng.standard_normal(d).astype(np.float32)
    close(L.rmsnorm(t(x), t(w), 1e-6), JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 80)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(4090, 4099)]).astype(np.int32)
    close(L.apply_rope(t(x), t(pos), theta), JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                                          theta))


ATTN_PATTERNS = {"full": {}, "swa": {"window": 20}, "chunked": {"chunk": 16}}
BLOCKS = {"one block": {}, "several blocks": {"q_block": 16, "kv_block": 32}}


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("blocks", list(BLOCKS))
@pytest.mark.parametrize("pattern", list(ATTN_PATTERNS))
def test_blockwise_attention(pattern, blocks, segments):
    rng = np.random.default_rng(7)
    s = 64
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    kw = dict(pattern=pattern, **ATTN_PATTERNS[pattern], **BLOCKS[blocks])
    if segments:
        seg = np.sort(rng.integers(0, 3, (2, s)), axis=1).astype(np.int32)
        kw.update(segment_ids_q=seg, segment_ids_kv=seg)
    got = L.blockwise_attention(t(q), t(k), t(v), **{
        key: t(val) if isinstance(val, np.ndarray) else val for key, val in kw.items()})
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **{
        key: jnp.asarray(val) if isinstance(val, np.ndarray) else val for key, val in kw.items()})
    close(got, want)


def test_blockwise_attention_refuses_blocks_that_do_not_divide():
    x = torch.zeros((1, 520, 2, 8))
    with pytest.raises(ValueError, match="do not split"):
        L.blockwise_attention(x, x, x)


@pytest.mark.parametrize("pattern", list(ATTN_PATTERNS))
def test_decode_attention_past_the_window(pattern):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    n = np.array([50, 61], np.int32)  # past swa's window of 20
    kw = dict(pattern=pattern, **ATTN_PATTERNS[pattern])
    close(L.decode_attention(t(q), t(kc), t(vc), t(n), **kw),
          JL.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(n), **kw))


# ---------------------------------------------------------------------------
# prefill + greedy decode


@pytest.fixture(scope="module")
def dense_runs():
    out = {}
    for arch in DENSE:
        out[arch] = run_both(JR.get_arch(arch).reduced, PR.get_arch(arch).reduced)
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_match(dense_runs, arch):
    ref, port = dense_runs[arch]
    assert tuple(port["prefill"].shape) == ref["prefill"].shape
    close(port["prefill"], ref["prefill"])


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_caches_match(dense_runs, arch):
    ref, port = dense_runs[arch]
    got = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), port["caches"]))
    want = jax.tree.leaves(ref["caches"])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_decode_matches(dense_runs, arch):
    ref, port = dense_runs[arch]
    for got, want in zip(port["logits"], ref["logits"]):
        close(got, want)
    assert np.array_equal(np.concatenate(port["tokens"], 1), np.concatenate(ref["tokens"], 1))
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), port["caches_after"])),
                    jax.tree.leaves(ref["caches_after"])):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.fixture(scope="module")
def bf16_run():
    jcfg = dataclasses.replace(JR.get_arch("h2o-danube-1.8b").reduced, dtype="bfloat16")
    cfg = dataclasses.replace(PR.get_arch("h2o-danube-1.8b").reduced, dtype="bfloat16")
    return cfg, run_both(jcfg, cfg)


def test_bf16_logits_and_tokens_match(bf16_run):
    cfg, (ref, port) = bf16_run
    assert port["prefill"].dtype == torch.bfloat16
    close(port["prefill"], ref["prefill"], atol=BF16_ATOL, rtol=0)
    for got, want in zip(port["logits"], ref["logits"]):
        close(got, want, atol=BF16_ATOL, rtol=0)
    for got, want, logits in zip(port["tokens"], ref["tokens"], ref["logits"]):
        top2 = np.sort(logits[:, -1, :], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > BF16_ATOL
        assert np.array_equal(got[clear], want[clear])


def test_cast_weights_give_the_numbers_of_a_cast_per_call(bf16_run):
    cfg, (_, port) = bf16_run
    params, toks = port["params"], t(port["prompts"])
    once = T.cast_weights(params, cfg)
    assert once["layers"]["p0"]["attn"]["wq"].dtype == torch.bfloat16
    assert once["final_ln"].dtype == torch.float32  # norms stay in the param dtype
    a, _ = T.prefill(params, toks, cfg, RULES, PROMPT + 1)
    b, _ = T.prefill(once, toks, cfg, RULES, PROMPT + 1)
    assert torch.equal(a, b)


def test_padded_vocab_rows_are_masked_in_both():
    jcfg = dataclasses.replace(JR.get_arch("h2o-danube-1.8b").reduced, vocab_size=500)
    cfg = dataclasses.replace(PR.get_arch("h2o-danube-1.8b").reduced, vocab_size=500)
    assert cfg.padded_vocab == 512
    ref, port = run_both(jcfg, cfg, decode=1)
    for logits in (ref["prefill"], ref["logits"][0], port["prefill"].numpy(),
                   port["logits"][0].numpy()):
        assert logits.shape[-1] == 512
        assert np.all(logits[..., 500:] == np.float32(-1e30))
        assert np.all(logits[..., :500] > -1e29)
    close(port["prefill"], ref["prefill"])


def test_c11_writing_past_the_cache_raises_where_the_reference_clamps():
    jcfg, cfg = JR.get_arch("gemma-7b").reduced, PR.get_arch("gemma-7b").reduced
    ref, port = run_both(jcfg, cfg, prompt=8, decode=1)
    max_seq = 9
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    tok = np.full((B, 1), 5, np.int32)
    # the reference: cache_len == max_seq lands on the last slot
    jc = jax.tree.map(jnp.asarray, ref["caches_after"])
    _, jc2 = JT.decode_step(jax.tree.map(jnp.asarray, tree), jnp.asarray(tok), jc,
                            jnp.int32(max_seq), jcfg, J_RULES)
    before, after = np.asarray(jc["p0"]["k"]), np.asarray(jc2["p0"]["k"])
    assert not np.array_equal(before[:, :, -1], after[:, :, -1])
    assert np.array_equal(before[:, :, :-1], after[:, :, :-1])
    # the port: a host check, the cache untouched
    pc = port["caches_after"]
    kept = pc["p0"]["k"].clone()
    for n in (max_seq, max_seq + 3, -1):
        with pytest.raises(ValueError, match="outside the cache"):
            T.decode_step(port["params"], t(tok), pc, n, cfg, RULES)
    assert torch.equal(pc["p0"]["k"], kept)


# ---------------------------------------------------------------------------
# the CLI


def test_serve_cli_prints_the_reference_lines():
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = serve.main(["--reduced", "--device", "cpu", "--batch", "2", "--gen", "5"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("h2o-danube-1.8b-smoke: prefill(2x64) ")
    assert "decode 4 steps" in lines[0] and "tok/s" in lines[0] and lines[0].endswith("[cpu]")
    assert lines[1].startswith("sample token ids: [")
    assert out["tokens"].shape == (2, 5) and out["card"] == "cpu"


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])
