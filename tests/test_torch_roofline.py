"""The port's bookkeeping against the JAX package's: ``launch.roofline``
(parameter and model-FLOP counts, the terms' arithmetic), ``launch.specs``
(``shape_rules``, ``input_specs``, ``auto_microbatches``) and the
``common.util`` helpers.  The mirror of ``tests/test_configs_roofline.py``
where it needs no HLO.  Counts equal the reference's exactly, as integers
and floats; the terms differ only in the card's rates (H100 for v5e)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import util as JU
from repro.configs import registry as JR
from repro.launch import roofline as JRf
from repro.launch import specs as JSp
from repro.models import transformer as JT
from repro.models.config import SHAPES as J_SHAPES
from repro_torch.common import util as U
from repro_torch.configs import registry as PR
from repro_torch.distributed.sharding import ShardingRules, entry_axes
from repro_torch.launch import roofline as Rf
from repro_torch.launch import specs as Sp
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.layers import ParamTree

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def shape_mesh(name: str):
    """A mesh of shape only: ``auto_microbatches`` and the rules read no
    more, so nothing is spawned."""
    shape = MESHES[name]
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def configs(arch):
    return [(JR.get_arch(arch).config, PR.get_arch(arch).config),
            (JR.get_arch(arch).reduced, PR.get_arch(arch).reduced)]


@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    for jcfg, cfg in configs(arch):
        total, active = Rf.param_counts(cfg)
        assert (total, active) == JRf.param_counts(jcfg)
        assert isinstance(total, int) and isinstance(active, int) and active <= total


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_model_flops_equal_the_reference(arch, shape):
    for jcfg, cfg in configs(arch):
        got = Rf.model_flops(cfg, SHAPES[shape])
        assert got == JRf.model_flops(jcfg, J_SHAPES[shape]) > 0
        for kind in ("train", "prefill", "decode"):
            assert Rf.model_flops(cfg, SHAPES[shape], kind) == JRf.model_flops(
                jcfg, J_SHAPES[shape], kind)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape):
    jcfg, cfg = configs(arch)[0]
    got = Sp.input_specs(cfg, shape)
    want = JSp.input_specs(jcfg, shape)
    is_rec = lambda x: isinstance(x, U.ShapeDtype)  # noqa: E731
    flat_got = jax.tree_util.tree_flatten_with_path(got, is_leaf=is_rec)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert isinstance(g, U.ShapeDtype), path
        assert g.shape == tuple(w.shape) and all(d > 0 for d in g.shape), path
        assert _dtype_name(g.dtype) == str(w.dtype), path
    assert U.bytes_of_tree(got) == JU.bytes_of_tree(want)


@pytest.mark.parametrize("mesh", [None, "single", "multi"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_shape_rules_equal_the_reference(arch, shape, mesh):
    jcfg, cfg = configs(arch)[0]
    m = None if mesh is None else shape_mesh(mesh)
    got = Sp.shape_rules(cfg, SHAPES[shape], m)
    want = JSp.shape_rules(jcfg, J_SHAPES[shape], m)
    assert got.mapping == want.mapping and got.mesh is m
    assert axes_of(Sp.train_batch_pspecs(cfg, SHAPES[shape], got)) == axes_of(
        JSp.train_batch_pspecs(jcfg, J_SHAPES[shape], want))


def axes_of(tree):
    """Each spec entry as its mesh axes (jax's PartitionSpec writes a
    1-tuple entry as its one name)."""
    return {k: tuple(entry_axes(e) for e in v) for k, v in tree.items()}


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", JR.ARCH_IDS)
def test_auto_microbatches_equal_the_reference(arch, shape, mesh):
    m = shape_mesh(mesh)
    for jcfg, cfg in configs(arch):
        got = Sp.auto_microbatches(cfg, SHAPES[shape], m)
        assert got == JSp.auto_microbatches(jcfg, J_SHAPES[shape], m) >= 1
    assert Sp.auto_microbatches(configs(arch)[0][1], SHAPES[shape], None) == (
        configs(arch)[0][1].microbatches or 1)


def test_util_helpers_equal_the_reference():
    jcfg, cfg = JR.get_arch("jamba-v0.1-52b").reduced, PR.get_arch("jamba-v0.1-52b").reduced
    jtree = JT.init_params(jax.random.PRNGKey(0), jcfg)
    ntree = jax.tree.map(np.asarray, jtree)
    ttree = T.params_from_numpy(ntree, cfg, "cpu")
    want_b, want_n = JU.bytes_of_tree(jtree), JU.param_count(jtree)
    assert want_n == Rf.param_counts(cfg)[0]
    for tree in (ntree, ttree, ParamTree(ttree), [ttree, ()], T.cache_spec(cfg, 2, 8)):
        if isinstance(tree, dict) and "p0" in tree:  # the cache's meta tensors
            jcache = JT.cache_spec(jcfg, 2, 8)
            assert U.bytes_of_tree(tree) == JU.bytes_of_tree(jcache)
            assert U.param_count(tree) == JU.param_count(jcache)
            continue
        assert U.bytes_of_tree(tree) == want_b
        assert U.param_count(tree) == want_n
    bf16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jtree)
    assert U.bytes_of_tree(jax.tree.map(lambda x: x.to(torch.bfloat16), ttree)) == \
        JU.bytes_of_tree(bf16)
    for n in (0, 1, 1023.9, 1024, 5 * 2**30, 3.5e18, -2048):
        assert U.human_bytes(n) == JU.human_bytes(n)
    for n in (0, 999, 1000, 2.5e12, 9.9e17, 3e20):
        assert U.human_flops(n) == JU.human_flops(n)


def test_roofline_terms_arithmetic():
    terms = Rf.RooflineTerms(flops_per_dev=2 * 989e12, hbm_bytes_per_dev=3.35e12,
                             coll_bytes_per_dev=int(4.5e11), coll_breakdown={"all-to-all": 7},
                             model_flops_global=989e12, chips=2)
    assert terms.compute_s == 2.0 and terms.memory_s == 1.0 and terms.collective_s == 1.0
    assert terms.dominant == "compute" and terms.bound_s == 2.0
    assert terms.useful_ratio == 989e12 / (2 * 2 * 989e12)
    assert terms.roofline_fraction == 0.5 / 2.0
    want = JRf.RooflineTerms(1.0, 1.0, 1, {}, 1.0, 1).to_json()
    assert list(terms.to_json()) == list(want)
    assert Rf.LINK_BW * 2 == Rf.NVLINK_BW == 900e9
    assert (Rf.PEAK_FLOPS, Rf.HBM_BW) == (989e12, 3.35e12)
    # the same arithmetic as the reference's, at the reference's rates
    j = JRf.RooflineTerms(5e12, 4e11, 3 * 10**9, {}, 1e12, 4)
    assert j.useful_ratio == Rf.RooflineTerms(5e12, 4e11, 3 * 10**9, {}, 1e12, 4).useful_ratio


def test_derive_counts_a_reduced_h2o_step_above_its_model_flops():
    """``FlopCounterMode`` over the loss and its backward: the matrix
    products of every layer, the attention and the head, at least 6·N·T;
    bytes at least the parameters, the batch and the gradients."""
    cfg = PR.get_arch("h2o-danube-1.8b").reduced
    jcfg = JR.get_arch("h2o-danube-1.8b").reduced
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    model = ParamTree(T.params_from_numpy(tree, cfg, "cpu"))
    b, s = 2, 256
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, (b, s + 1))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": torch.ones(b, s)}
    rules = ShardingRules.make(None)

    def step(m, bt):
        loss, _ = T.loss_fn(m.tree(), bt, cfg, rules)
        loss.backward()
        return {k: p.grad for k, p in m.named_parameters()}

    shape = ShapeConfig("t", s, b, "train")
    terms = Rf.derive(step, (model, batch), cfg, shape)
    assert terms.model_flops_global == JRf.model_flops(jcfg, dataclasses.replace(
        J_SHAPES["train_4k"], seq_len=s, global_batch=b))
    assert terms.flops_per_dev >= terms.model_flops_global > 0
    assert 0 < terms.useful_ratio <= 1
    assert terms.hbm_bytes_per_dev == 2 * U.bytes_of_tree(model) + U.bytes_of_tree(batch)
    assert terms.coll_bytes_per_dev == 0 and terms.coll_breakdown == {}
    assert terms.dominant in ("compute", "memory")
