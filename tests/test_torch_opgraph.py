"""The port's operator-graph lowering under every placement, and its cost
model, against the JAX package's on the same inputs (CPU: the plain
versions against the interpreted Pallas kernels).

Integers and ``labels`` must match the reference bitwise; ``dense`` to
rtol=atol=1e-6 with NaN equal (log1p may differ by 1 ulp between the two
libraries).  Between the port's own lowerings every output, dense included,
must be bitwise equal: fused and unfused run the same arithmetic.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costmodel as jcost
from repro.core.opgraph import lower_transform as j_lower_transform
from repro.core.opgraph import resolve_placements as j_resolve_placements
from repro.core.preprocess import pages_from_partition as j_pages_from_partition
from repro.core.spec import TransformSpec as JSpec
from repro.data.synth import RMDataConfig as JCfg
from repro.data.synth import SyntheticRecSysSource as JSource
from repro.data.synth import make_rm_source as j_make_rm_source
from repro_torch.core import costmodel
from repro_torch.core.opgraph import (
    FAMILIES,
    group_times_by_placement,
    lower_transform,
    resolve_placements,
    time_stages,
)
from repro_torch.core.preprocess import (
    flatten_megabatch,
    pages_from_partition,
    preprocess_pages,
    stack_pages,
    stage_functions,
)
from repro_torch.core.spec import TransformSpec
from repro_torch.data.synth import RMDataConfig, SyntheticRecSysSource, make_rm_source

DENSE_TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=True)
SMALL = ("t", 4, 3, 4, 8, 2, 32, 1 << 16, 1024)
MIXED = {"dense": "host", "gen": "host", "labels": "host"}
MODES = {"fused": "fused", "unfused": "unfused", "hybrid": "hybrid", "mixed": MIXED}


def _sources(geom: str):
    """(JAX source, port source) over the same geometry."""
    if geom == "small":
        return (JSource(JCfg(*SMALL, rows_per_partition=256), rows=256),
                SyntheticRecSysSource(RMDataConfig(*SMALL, rows_per_partition=256), rows=256))
    if geom == "dedup":
        return (JSource(JCfg(*SMALL, rows_per_partition=256, dup_factor=4), rows=256),
                SyntheticRecSysSource(
                    RMDataConfig(*SMALL, rows_per_partition=256, dup_factor=4), rows=256))
    if geom == "rm1-256":
        return j_make_rm_source("rm1", rows=256), make_rm_source("rm1", rows=256)
    return j_make_rm_source(geom), make_rm_source(geom)


@pytest.fixture(scope="module", params=["small", "rm1-256"])
def geom(request):
    """Specs and pid-0 pages of one geometry, in both packages."""
    jsrc, src = _sources(request.param)
    jspec, spec = JSpec.from_source(jsrc), TransformSpec.from_source(src)
    jpages = {k: jnp.asarray(v) for k, v in j_pages_from_partition(jsrc.partition(0), jspec).items()}
    pages = {k: torch.from_numpy(v.view(np.int32))
             for k, v in pages_from_partition(src.partition(0), spec).items()}
    return {"name": request.param, "spec": spec, "jspec": jspec, "pages": pages,
            "jpages": jpages, "src": src}


def _assert_batch_equal_reference(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (what, key)
        if key == "dense":
            np.testing.assert_allclose(g, w, **DENSE_TOL, err_msg=f"{what}/{key}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}/{key}")


def _assert_batch_bitwise(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        if key == "dense":
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m: f"{what}/{key}: {m}")
        else:
            assert torch.equal(got[key], want[key]), f"{what}/{key}"


@pytest.mark.parametrize("mode", list(MODES))
def test_lowering_matches_reference(geom, mode):
    """Each mode's batch equals the reference's lowering of the same mode,
    and the plan has the reference's stages and structural hash."""
    plan = lower_transform(geom["spec"], MODES[mode], device="cpu")
    jplan = j_lower_transform(geom["jspec"], MODES[mode])
    assert [(s.name, s.kind, s.placement) for s in plan.stages] == [
        (s.name, s.kind, s.placement) for s in jplan.stages
    ]
    assert plan.structural_hash() == jplan.structural_hash()
    assert plan.host_families() == jplan.host_families()
    _assert_batch_equal_reference(plan.execute(geom["pages"]), jplan.execute(geom["jpages"]),
                                  f"{geom['name']}/{mode}")


def test_port_lowerings_bitwise_equal(geom):
    """fused, unfused, hybrid and the mixed dict give one batch, bit for
    bit, dense included."""
    outs = {mode: lower_transform(geom["spec"], m, device="cpu").execute(geom["pages"])
            for mode, m in MODES.items()}
    for mode, mb in outs.items():
        _assert_batch_bitwise(mb, outs["fused"], f"{geom['name']}/{mode}")
    for mode, m in MODES.items():
        _assert_batch_bitwise(preprocess_pages(geom["pages"], geom["spec"], mode=m),
                              outs["fused"], f"preprocess_pages/{mode}")


def test_hybrid_sends_gen_to_host_at_rm1():
    """At rm1 the cost model sends gen to the host (at the small geometry it
    keeps everything on ISP), so the hybrid plan runs host stages."""
    _, src = _sources("rm1-256")
    plan = lower_transform(TransformSpec.from_source(src), "hybrid", device="cpu")
    assert plan.host_families() == ("gen",)
    assert [s.name for s in plan.stages if s.placement == "host"] == [
        "decode_gen", "bucketize_gen", "hash_gen"]
    assert plan.stage("fused_dense").placement == "isp"
    with pytest.raises(KeyError):
        plan.stage("decode_dense")


@pytest.mark.parametrize("geom_name", ["small", "dedup", "rm1", "rm2", "rm5"])
def test_cost_model_matches_reference(geom_name):
    """Placements, modeled seconds and op counts equal the reference's
    exactly (the same float arithmetic in the same order)."""
    jsrc, src = _sources(geom_name)
    jspec, spec = JSpec.from_source(jsrc), TransformSpec.from_source(src)
    for rows in (None, 256, 8192):
        assert resolve_placements("hybrid", spec, rows) == j_resolve_placements(
            "hybrid", jspec, rows)
        assert costmodel.choose_placement(spec, rows) == jcost.choose_placement(jspec, rows)
        assert costmodel.placement_costs(spec, rows) == jcost.placement_costs(jspec, rows)
        assert dataclasses.asdict(costmodel.partition_costs(spec, rows)) == dataclasses.asdict(
            jcost.partition_costs(jspec, rows))
        r = rows or spec.cfg.rows_per_partition
        assert costmodel.family_compute_ops(spec, r) == jcost.family_compute_ops(jspec, r)
    model = costmodel.PlacementCostModel(link_bytes_per_s=1e9, host_ops_per_s=1e12)
    jmodel = jcost.PlacementCostModel(link_bytes_per_s=1e9, host_ops_per_s=1e12)
    assert costmodel.choose_placement(spec, None, model) == jcost.choose_placement(
        jspec, None, jmodel)
    assert costmodel.placement_costs(spec, None, model) == jcost.placement_costs(
        jspec, None, jmodel)


def test_megabatch_cost_helpers_match_reference():
    m, jm = costmodel.DEFAULT_PLACEMENT_MODEL, jcost.DEFAULT_PLACEMENT_MODEL
    assert dataclasses.asdict(m) == dataclasses.asdict(jm)
    for per, k in ((0.0, 1), (1e-4, 4), (3e-3, 16)):
        assert m.megabatch_launch_s(per, k) == jm.megabatch_launch_s(per, k)
        assert m.megabatch_amortization(per, k) == jm.megabatch_amortization(per, k)
        assert m.predicted_megabatch_k(per, 32) == jm.predicted_megabatch_k(per, 32)
        assert m.predicted_megabatch_k(per, 8, candidates=[1, 2, 8]) == jm.predicted_megabatch_k(
            per, 8, candidates=[1, 2, 8])


def test_time_stages_and_placement_groups(geom):
    plan = lower_transform(geom["spec"], MIXED, device="cpu")
    times = time_stages(plan, geom["pages"], iters=2)
    assert list(times) == [s.name for s in plan.stages]
    assert all(t >= 0.0 for t in times.values())
    groups = group_times_by_placement(plan, times)
    assert set(groups) == {"isp", "host", "local"}
    assert sum(groups.values()) == pytest.approx(sum(times.values()))


def test_stage_functions_compose(geom):
    """The paper's five stages, composed, give preprocess_pages's batch."""
    pages, spec = geom["pages"], geom["spec"]
    stages = stage_functions(spec, device="cpu")
    assert set(stages) == {"extract_decode", "gen_bucketize", "norm_sigridhash",
                           "norm_log", "form_minibatch"}
    dense_raw, sparse_raw = stages["extract_decode"](pages)
    bucket_ids = stages["gen_bucketize"](dense_raw)
    hashed, gen_hashed = stages["norm_sigridhash"](sparse_raw, bucket_ids)
    dense_norm = stages["norm_log"](dense_raw)
    mb = stages["form_minibatch"](pages, dense_norm, hashed, gen_hashed)
    _assert_batch_bitwise(mb, preprocess_pages(pages, spec), "stage_functions")


@pytest.mark.parametrize("mode", ["unfused", "hybrid"])
def test_megabatch_through_host_stages_equals_solo_runs(geom, mode):
    """Every host stage is row-local: K=2 partitions in one pass (sigridhash
    over (F, 2*G*32) included) equal two solo runs."""
    spec, src = geom["spec"], geom["src"]
    plan = lower_transform(spec, mode, device="cpu")
    assert plan.megabatch_safe()
    solo = [pages_from_partition(src.partition(pid), spec) for pid in (0, 1)]
    stacked = {k: torch.from_numpy(v.view(np.int32)) for k, v in stack_pages(solo).items()}
    mb = plan.execute(flatten_megabatch(stacked))
    rows = src.rows
    for i, p in enumerate(solo):
        want = plan.execute({k: torch.from_numpy(v.view(np.int32)) for k, v in p.items()})
        got = {k: v[i * rows:(i + 1) * rows] for k, v in mb.items()}
        _assert_batch_bitwise(got, want, f"{mode}/pid{i}")


def test_resolve_placements_modes():
    _, src = _sources("small")
    spec = TransformSpec.from_source(src)
    assert set(resolve_placements("disagg", spec).values()) == {"host"}
    assert set(resolve_placements("presto", spec).values()) == {"isp"}
    assert resolve_placements({"gen": "host"}, spec) == {
        f: ("host" if f == "gen" else "isp") for f in FAMILIES}
    with pytest.raises(ValueError, match="unknown mode"):
        resolve_placements("warp", spec)
    with pytest.raises(ValueError, match="'isp' or 'host'"):
        resolve_placements({"gen": "gpu"}, spec)


def test_spec_tables_and_graph_equal_the_reference(geom):
    """``TransformSpec.n_tables``, ``table_sizes()`` (bitwise, int64) and
    ``graph()`` (the node names of ``build_transform_graph``'s graph, as
    ``tests/test_opgraph.py`` holds the reference's)."""
    from repro_torch.core.opgraph import build_transform_graph

    spec, jspec = geom["spec"], geom["jspec"]
    assert spec.n_tables == jspec.n_tables == spec.cfg.n_sparse + spec.cfg.n_generated
    got, want = spec.table_sizes(), jspec.table_sizes()
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)
    names = [n.name for n in spec.graph().nodes]
    assert names == [n.name for n in jspec.graph().nodes]
    assert names == [n.name for n in build_transform_graph(spec).nodes]
