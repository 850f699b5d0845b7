"""The slice as a whole: ``TorchPreStoEngine`` on the CPU (the plain path)
against the JAX package's ``PreStoEngine`` on the same store pids.

Integers and ``labels`` must match bitwise; ``dense`` to rtol=atol=1e-6 with
NaN equal (log1p may differ by 1 ulp between the two libraries).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.opgraph import family_batch_bytes as j_family_batch_bytes
from repro.core.opgraph import family_page_bytes as j_family_page_bytes
from repro.core.opgraph import lower_transform as j_lower_transform
from repro.core.presto import PreStoEngine
from repro.core.spec import TransformSpec as JSpec
from repro.data.storage import PartitionedStore as JStore
from repro.data.synth import RMDataConfig as JCfg
from repro.data.synth import SyntheticRecSysSource as JSource
from repro.data.synth import make_rm_source as j_make_rm_source
from repro.kernels import ref as jref
from repro_torch.core.opgraph import family_batch_bytes, family_page_bytes, lower_transform
from repro_torch.core.preprocess import (
    execute_plan,
    minibatch_shape_dtypes,
    pages_from_partition,
    preprocess_pages,
)
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec, spec_from_arrays
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import RMDataConfig, SyntheticRecSysSource, make_rm_source

DENSE_TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=True)
N_PIDS = 5  # at megabatch 2, the last chunk is a remainder of one
SMALL = ("t", 4, 3, 4, 8, 2, 32, 1 << 16, 1024)


@pytest.fixture(scope="module")
def small_rm():
    """JAX and port stores over the same geometry, a port spec carried
    across from the JAX spec, and the JAX engine's batch for every pid."""
    jsrc = JSource(JCfg(*SMALL, rows_per_partition=256), rows=256)
    jspec = JSpec.from_source(jsrc)
    spec = spec_from_arrays(dataclasses.asdict(jspec.cfg), {
        "bucket_boundaries": jspec.bucket_boundaries,
        "generated_source": np.asarray(jspec.generated_source),
        "sparse_seeds": jspec.sparse_seeds,
        "sparse_max": jspec.sparse_max,
        "gen_seeds": jspec.gen_seeds,
        "gen_max": jspec.gen_max,
    })
    src = SyntheticRecSysSource(RMDataConfig(*SMALL, rows_per_partition=256), rows=256)
    jengine = PreStoEngine(jspec)
    jstore = JStore(N_PIDS, 2, jsrc)
    want = {pid: jengine.produce_batch(jstore, pid) for pid in range(N_PIDS)}
    return {
        "spec": spec, "jspec": jspec, "jengine": jengine, "src": src, "jsrc": jsrc,
        "store": PartitionedStore(N_PIDS, 2, src), "want": want,
    }


def _assert_batch_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key == "dense":
            np.testing.assert_allclose(g, w, **DENSE_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_produce_batch_matches_reference(small_rm):
    engine = TorchPreStoEngine(small_rm["spec"], device="cpu")
    for pid in range(N_PIDS):
        mb = engine.produce_batch(small_rm["store"], pid)
        _assert_batch_equal(mb, small_rm["want"][pid])
        for key, sd in minibatch_shape_dtypes(small_rm["spec"], 256).items():
            assert tuple(mb[key].shape) == sd.shape and mb[key].dtype == sd.dtype, key
            assert mb[key].is_contiguous(), key


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("megabatch", [1, 2])
def test_produce_stream_matches_reference(small_rm, megabatch, overlap):
    engine = TorchPreStoEngine(small_rm["spec"], device="cpu")
    out = list(engine.produce_stream(
        small_rm["store"], range(N_PIDS), megabatch=megabatch, overlap=overlap
    ))
    assert [pid for pid, _ in out] == list(range(N_PIDS))
    for pid, mb in out:
        _assert_batch_equal(mb, small_rm["want"][pid])


def test_produce_batches_megabatch_matches_reference(small_rm):
    engine = TorchPreStoEngine(small_rm["spec"], device="cpu")
    for pid, mb in zip((3, 1, 4), engine.produce_batches(small_rm["store"], [3, 1, 4])):
        _assert_batch_equal(mb, small_rm["want"][pid])


def test_deep_lookahead_stream_matches_reference(small_rm):
    engine = TorchPreStoEngine(small_rm["spec"], device="cpu")
    out = list(engine.produce_stream(
        small_rm["store"], [4, 0, 2], megabatch=2, lookahead=3
    ))
    assert [pid for pid, _ in out] == [4, 0, 2]
    for pid, mb in out:
        _assert_batch_equal(mb, small_rm["want"][pid])


def test_preprocess_matches_raw_oracle(small_rm):
    """The port's batch against the raw (pre-encoding) features, as
    ``tests/test_preprocess.py`` holds the reference."""
    spec, src = small_rm["spec"], small_rm["src"]
    raw = src.raw(1)
    pages = {k: torch.from_numpy(v.view(np.int32))
             for k, v in pages_from_partition(src.partition(1), spec).items()}
    mb = preprocess_pages(pages, spec)
    np.testing.assert_allclose(
        mb["dense"].numpy(), np.log1p(np.maximum(raw.dense, 0)), atol=1e-6
    )
    np.testing.assert_array_equal(mb["lengths"].numpy(), raw.sparse_lengths)
    np.testing.assert_array_equal(mb["labels"].numpy(), raw.labels)
    s0 = np.asarray(jref.sigridhash(jnp.asarray(raw.sparse_values[:, 0]),
                                    int(spec.sparse_seeds[0]), int(spec.sparse_max[0])))
    np.testing.assert_array_equal(mb["multi_hot_ids"][:, 0].numpy(), s0)
    b0 = np.digitize(raw.dense[:, spec.generated_source[0]], spec.bucket_boundaries[0])
    g0 = np.asarray(jref.sigridhash(jnp.asarray(b0.astype(np.int32)),
                                    int(spec.gen_seeds[0]), int(spec.gen_max[0])))
    np.testing.assert_array_equal(mb["one_hot_ids"][:, 0].numpy(), g0)


def test_structural_hash_equals_reference_signature_differs(small_rm):
    """Same graph, same lowering: the plan hashes as the reference's.  The
    engine's cache signature carries a backend tag, so it never collides
    with a JAX engine's."""
    spec, jspec = small_rm["spec"], small_rm["jspec"]
    plan = lower_transform(spec, "presto", device="cpu")
    jplan = j_lower_transform(jspec, "presto")
    assert plan.structural_hash() == jplan.structural_hash()
    assert [(s.name, s.kind, s.placement) for s in plan.stages] == [
        (s.name, s.kind, s.placement) for s in jplan.stages
    ]
    assert plan.megabatch_safe()
    a = TorchPreStoEngine(spec, device="cpu")
    b = TorchPreStoEngine(TransformSpec.from_source(small_rm["src"]), device="cpu")
    assert a.cache_signature() == b.cache_signature()
    assert a.cache_signature() != small_rm["jengine"].cache_signature()
    assert a.lowered_plan.structural_hash() == small_rm["jengine"].lowered_plan.structural_hash()


@pytest.mark.parametrize("kind", ["small_rm", "small_rm_dedup", "rm2"])
def test_family_byte_accounting_matches_reference(kind):
    """Per-family page and batch bytes equal the reference's; at rm2 the
    stored pages (every family but the gathered gen planes) are the
    49,836,032 bytes that one partition copies to the device."""
    if kind == "rm2":
        jsrc, src = j_make_rm_source("rm2"), make_rm_source("rm2")
    else:
        dup = 4 if kind == "small_rm_dedup" else 1
        jsrc = JSource(JCfg(*SMALL, rows_per_partition=256, dup_factor=dup), rows=256)
        src = SyntheticRecSysSource(
            RMDataConfig(*SMALL, rows_per_partition=256, dup_factor=dup), rows=256)
    spec, jspec = TransformSpec.from_source(src), JSpec.from_source(jsrc)
    pages = family_page_bytes(spec, src.rows)
    assert pages == j_family_page_bytes(jspec, jsrc.rows)
    assert family_batch_bytes(spec, src.rows) == j_family_batch_bytes(jspec, jsrc.rows)
    if kind == "rm2":
        assert sum(pages.values()) - pages["gen"] == 49_836_032


ENGINE_PLACEMENTS = ["presto", "disagg", "hybrid", {"gen": "host"}]
KERNEL_MODES = [None, "fused", "unfused"]
_PLACEMENT_IDS = ["presto", "disagg", "hybrid", "gen-host"]


def _engines(small_rm, placement, kernel_mode):
    engine = TorchPreStoEngine(small_rm["spec"], placement=placement,
                               kernel_mode=kernel_mode, device="cpu")
    jengine = PreStoEngine(small_rm["jspec"], placement=placement, kernel_mode=kernel_mode)
    return engine, jengine


@pytest.mark.parametrize("kernel_mode", KERNEL_MODES)
@pytest.mark.parametrize("placement", ENGINE_PLACEMENTS, ids=_PLACEMENT_IDS)
def test_engine_plan_matches_reference(small_rm, placement, kernel_mode):
    """Every (placement, kernel_mode) lowers the reference's plan: the same
    stages, structural hash, host families and route costs."""
    engine, jengine = _engines(small_rm, placement, kernel_mode)
    plan, jplan = engine.lowered_plan, jengine.lowered_plan
    assert [(s.name, s.kind, s.placement) for s in plan.stages] == [
        (s.name, s.kind, s.placement) for s in jplan.stages
    ]
    assert plan.structural_hash() == jplan.structural_hash()
    assert engine.host_families() == jengine.host_families()
    assert engine.family_placements == jengine.family_placements
    for rows in (None, 512):
        assert dataclasses.asdict(engine.route_costs(rows)) == dataclasses.asdict(
            jengine.route_costs(rows))


def test_disagg_keeps_the_fused_kernels_unless_unfused(small_rm):
    """``placement="disagg"`` moves every family's traffic to the host but
    lowers the fused kernels, as the reference does; only
    ``kernel_mode="unfused"`` lowers the multi-pass plan."""
    spec = small_rm["spec"]
    disagg = TorchPreStoEngine(spec, placement="disagg", device="cpu")
    assert disagg.host_families() == ("dense", "sparse", "gen", "lengths", "labels")
    assert [s.name for s in disagg.lowered_plan.stages][:3] == [
        "fused_dense", "fused_sparse", "fused_gen"]
    presto = TorchPreStoEngine(spec, device="cpu")
    assert disagg.lowered_plan.structural_hash() == presto.lowered_plan.structural_hash()
    assert disagg.cache_signature() != presto.cache_signature()
    unfused = TorchPreStoEngine(spec, placement="disagg", kernel_mode="unfused", device="cpu")
    assert not any(s.kind.startswith("fused:") for s in unfused.lowered_plan.stages)
    assert unfused.lowered_plan.host_families() == unfused.host_families()
    with pytest.raises(ValueError, match="placement"):
        TorchPreStoEngine(spec, placement="isp", device="cpu")


_JAX_STREAMS = {}


def _jax_stream(small_rm, jengine, megabatch):
    """The JAX engine's batches over every pid.  Without a mesh they depend
    on its lowered plan alone, so engines that lower alike share one run."""
    key = (jengine.lowered_plan.structural_hash(), megabatch)
    if key not in _JAX_STREAMS:
        jstore = JStore(N_PIDS, 2, small_rm["jsrc"])
        _JAX_STREAMS[key] = dict(jengine.produce_stream(jstore, range(N_PIDS),
                                                        megabatch=megabatch))
    return _JAX_STREAMS[key]


@pytest.mark.parametrize("megabatch", [1, 2])
@pytest.mark.parametrize("kernel_mode", KERNEL_MODES)
@pytest.mark.parametrize("placement", ENGINE_PLACEMENTS, ids=_PLACEMENT_IDS)
def test_engine_stream_matches_reference(small_rm, placement, kernel_mode, megabatch):
    engine, jengine = _engines(small_rm, placement, kernel_mode)
    want = _jax_stream(small_rm, jengine, megabatch)
    out = list(engine.produce_stream(small_rm["store"], range(N_PIDS), megabatch=megabatch))
    assert [pid for pid, _ in out] == list(range(N_PIDS))
    for pid, mb in out:
        _assert_batch_equal(mb, want[pid])
        _assert_batch_equal(mb, small_rm["want"][pid])


def test_dedup_pages_wait_for_a_later_slice():
    """Dedup pages (``sparse_refs``) run through ``execute_plan``: the batch
    equals that of the same partition inflated to the classic layout
    (``tests/test_torch_dedup.py`` holds them against the reference)."""
    from repro_torch.data.columnar import inflate_partition

    cfg = RMDataConfig(*SMALL, rows_per_partition=256, dup_factor=4)
    src = SyntheticRecSysSource(cfg, rows=256)
    spec = TransformSpec.from_source(src)
    part = src.partition(0)
    pages = pages_from_partition(part, spec)
    assert "sparse_refs" in pages
    plan = lower_transform(spec, device="cpu")
    as_t = lambda pg: {k: torch.from_numpy(v.view(np.int32)) for k, v in pg.items()}  # noqa: E731
    got = execute_plan(plan, as_t(pages))
    want = execute_plan(plan, as_t(pages_from_partition(inflate_partition(part), spec)))
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("dup", [1, 4])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_megabatch_pages_shape_dtypes_stack_the_references(dup, k):
    """The K-partition stand-ins: the reference's shapes, the port's int32
    page dtype, and the shapes ``stack_pages`` gives real pages."""
    from repro.core.preprocess import megabatch_pages_shape_dtypes as j_megabatch
    from repro.core.preprocess import pages_shape_dtypes as j_pages_shape_dtypes
    from repro_torch.core.preprocess import (
        megabatch_pages_shape_dtypes,
        pages_shape_dtypes,
        stack_pages,
    )

    src = SyntheticRecSysSource(RMDataConfig(*SMALL, rows_per_partition=256, dup_factor=dup),
                                rows=256)
    jsrc = JSource(JCfg(*SMALL, rows_per_partition=256, dup_factor=dup), rows=256)
    spec, jspec = TransformSpec.from_source(src), JSpec.from_source(jsrc)
    got = megabatch_pages_shape_dtypes(spec, 256, k)
    want = j_megabatch(jspec, 256, k)
    assert list(got) == list(want) == list(j_pages_shape_dtypes(jspec, 256))
    for name, sd in got.items():
        assert sd.shape == tuple(want[name].shape) == (k, *pages_shape_dtypes(spec, 256)[name].shape)
        assert sd.dtype == torch.int32
    stacked = stack_pages([pages_from_partition(src.partition(p), spec) for p in range(k)])
    assert {n: tuple(v.shape) for n, v in stacked.items()} == {n: sd.shape for n, sd in got.items()}
