"""Sample-level dedup (RecD) on the port's produce path, against the JAX
package at the reference's own ``dedup4`` geometry (rm2 at full width, 128
rows, every 4 rows one shared sparse block, seed 3).

A dedup partition stages its sparse and length pages at unique-block
geometry plus a ``sparse_refs`` vector; the Transform hashes each block once
and gather-expands through the refs before ``form_batch``.  Integers and
``labels`` must match the reference bitwise; ``dense`` to rtol=atol=1e-6
with NaN equal (log1p may differ by 1 ulp between the two libraries).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.preprocess import flatten_megabatch as j_flatten_megabatch
from repro.core.presto import PreStoEngine
from repro.core.spec import TransformSpec as JSpec
from repro.data.columnar import inflate_partition as j_inflate_partition
from repro.data.storage import PartitionedStore as JStore
from repro.data.synth import RM_CONFIGS as J_RM_CONFIGS
from repro.data.synth import SyntheticRecSysSource as JSource
from repro_torch.core.preprocess import (
    execute_plan,
    flatten_megabatch,
    pages_from_partition,
    stack_pages,
)
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.columnar import inflate_partition, partition_refs
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import RM_CONFIGS, SyntheticRecSysSource

DENSE_TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=True)
N_PIDS = 3  # at megabatch 2, the last chunk is a remainder of one
# (placement, kernel_mode): the fused kernels, the unfused (Disagg) plan, the
# cost model's hybrid
PATHS = [("presto", None), ("disagg", "unfused"), ("hybrid", None)]


def _cfg(configs, dup_factor):
    return dataclasses.replace(configs["rm2"], rows_per_partition=128, dup_factor=dup_factor)


def _tensors(pages):
    return {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32)) for k, v in pages.items()}


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


@pytest.fixture(scope="module")
def dedup4():
    jsrc = JSource(_cfg(J_RM_CONFIGS, 4), seed=3)
    src = SyntheticRecSysSource(_cfg(RM_CONFIGS, 4), seed=3)
    return {"jsrc": jsrc, "src": src, "jspec": JSpec.from_source(jsrc),
            "spec": TransformSpec.from_source(src),
            "store": PartitionedStore(N_PIDS, 2, src), "jstore": JStore(N_PIDS, 2, jsrc),
            "want": {}}


def _reference_batches(dedup4, placement, kernel_mode):
    """The JAX engine's batches of every pid (Pallas kernels interpreted),
    cached by its lowered plan."""
    engine = PreStoEngine(dedup4["jspec"], placement=placement, kernel_mode=kernel_mode,
                          interpret=True)
    key = engine.lowered_plan.structural_hash()
    if key not in dedup4["want"]:
        dedup4["want"][key] = dict(engine.produce_stream(dedup4["jstore"], range(N_PIDS)))
    return dedup4["want"][key]


def test_inflate_partition_matches_reference(dedup4):
    """The inflated partition equals the reference's page for page, bit for
    bit, under the same logical (dup 1, no refs) schema."""
    for pid in (0, 1):
        part, jpart = dedup4["src"].partition(pid), dedup4["jsrc"].partition(pid)
        flat, jflat = inflate_partition(part), j_inflate_partition(jpart)
        assert flat.schema.dup_factor == jflat.schema.dup_factor == 1
        assert flat.schema.rows == jflat.schema.rows
        assert [dataclasses.asdict(c) for c in flat.schema.columns] == [
            dataclasses.asdict(c) for c in jflat.schema.columns]
        assert partition_refs(flat) is None
        a, b = flat.page_arrays(), jflat.page_arrays()
        assert set(a) == set(b)
        for name in b:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        assert flat.nbytes() > part.nbytes()


@pytest.mark.parametrize("megabatch", [1, 2])
@pytest.mark.parametrize("placement,kernel_mode", PATHS)
def test_dedup_stream_matches_reference(dedup4, placement, kernel_mode, megabatch):
    """``produce_stream`` over a dedup store equals the reference engine's
    batches and the port's own batches of the inflated partitions."""
    want = _reference_batches(dedup4, placement, kernel_mode)
    engine = TorchPreStoEngine(dedup4["spec"], placement=placement, kernel_mode=kernel_mode,
                               device="cpu")
    out = list(engine.produce_stream(dedup4["store"], range(N_PIDS), megabatch=megabatch))
    assert [pid for pid, _ in out] == list(range(N_PIDS))
    for pid, mb in out:
        _assert_batch_equal(mb, want[pid])
        inflated = pages_from_partition(inflate_partition(dedup4["src"].partition(pid)),
                                        dedup4["spec"])
        assert "sparse_refs" not in inflated
        _assert_batch_equal(mb, engine.lowered_plan.execute(_tensors(inflated)))


def test_megabatch_matches_solo_and_offsets_refs_as_reference(dedup4):
    """Three dedup partitions in one megabatch equal three solo runs bit for
    bit, and the flattened refs point partition k's samples at its own
    blocks (offset k*u) exactly as the reference's flatten does."""
    spec = dedup4["spec"]
    engine = TorchPreStoEngine(spec, device="cpu")
    pages = [pages_from_partition(dedup4["src"].partition(p), spec) for p in range(N_PIDS)]
    stacked = stack_pages(pages)
    flat = flatten_megabatch(_tensors(stacked))
    jflat = j_flatten_megabatch(stacked)
    np.testing.assert_array_equal(flat["sparse_refs"].numpy(), np.asarray(jflat["sparse_refs"]))
    u = spec.cfg.rows_per_partition // 4
    np.testing.assert_array_equal(flat["sparse_refs"].numpy(),
                                  np.arange(N_PIDS * 128) // 4)
    assert int(flat["sparse_refs"].max()) == N_PIDS * u - 1
    mega = engine.preprocess_megabatch(_tensors(stacked))
    assert len(mega) == N_PIDS
    for i, pg in enumerate(pages):
        solo = execute_plan(engine.lowered_plan, _tensors(pg))
        for key in solo:
            assert torch.equal(mega[i][key], solo[key]), key


def test_dup_one_store_unchanged():
    """``dup_factor=1`` is the classic layout: no refs page, and the batch
    equals the reference's and that of the config without the field set."""
    src = SyntheticRecSysSource(_cfg(RM_CONFIGS, 1), seed=3)
    jsrc = JSource(_cfg(J_RM_CONFIGS, 1), seed=3)
    classic = SyntheticRecSysSource(
        dataclasses.replace(RM_CONFIGS["rm2"], rows_per_partition=128), seed=3)
    spec = TransformSpec.from_source(src)
    part = src.partition(2)
    assert partition_refs(part) is None and inflate_partition(part) is part
    pages = pages_from_partition(part, spec)
    assert "sparse_refs" not in pages
    for k, v in pages_from_partition(classic.partition(2), spec).items():
        np.testing.assert_array_equal(pages[k], v, err_msg=k)
    engine = TorchPreStoEngine(spec, device="cpu")
    jengine = PreStoEngine(JSpec.from_source(jsrc), interpret=True)
    _assert_batch_equal(engine.produce_batch(PartitionedStore(3, 1, src), 2),
                        jengine.produce_batch(JStore(3, 1, jsrc), 2))
