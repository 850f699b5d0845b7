"""The port's megabatched produce path, and engines that share nothing.

The produce-path half of the reference's ``tests/test_execcache.py``:
megabatched and streamed batches are bitwise equal to solo ones, and a plan
with a non-row-local stage degrades to solo launches.  The reference's
other half pins its process-wide executable registry; the port has no jit
and no registry, so here two engines of one signature each run their own
lowered plan, and a dropped engine is freed.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_recsys
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource


def _fixture(rows=256, partitions=12, rm="rm1"):
    rcfg = get_recsys(rm, reduced=True)
    src = SyntheticRecSysSource(rcfg.data, rows=rows)
    return TransformSpec.from_source(src), PartitionedStore(partitions, num_devices=4, source=src)


def _engine(spec, **kw):
    return TorchPreStoEngine(spec, device="cpu", **kw)


def _assert_bitwise(ref, got):
    assert sorted(got) == sorted(ref)
    for pid in ref:
        for key in ref[pid]:
            assert torch.equal(ref[pid][key], got[pid][key]), f"pid={pid} key={key}"


# -- megabatched execution ---------------------------------------------------------


@pytest.mark.parametrize("placement", ["presto", "hybrid"])
def test_produce_batches_bitwise_identical_to_solo(placement):
    spec, store = _fixture(partitions=6)
    engine = _engine(spec, placement=placement)
    solo = {pid: engine.produce_batch(store, pid) for pid in range(6)}
    mega = dict(zip(range(6), engine.produce_batches(store, range(6))))
    _assert_bitwise(solo, mega)


@pytest.mark.parametrize("megabatch,overlap", [(1, True), (3, True), (4, False), (5, True)])
def test_produce_stream_bitwise_with_remainder_chunks(megabatch, overlap):
    spec, store = _fixture(partitions=10)
    engine = _engine(spec)
    solo = {pid: engine.produce_batch(store, pid) for pid in range(10)}
    out = list(engine.produce_stream(store, range(10), megabatch=megabatch, overlap=overlap))
    assert [pid for pid, _ in out] == list(range(10))
    _assert_bitwise(solo, dict(out))


def test_megabatch_refuses_non_row_local_stage(monkeypatch):
    spec, store = _fixture(partitions=2)
    engine = _engine(spec)
    plan = engine.lowered_plan
    assert plan.megabatch_safe()
    monkeypatch.setattr(plan.stages[0], "kind", "batchnorm.partition")
    assert not plan.megabatch_safe()
    pages = {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32))
             for k, v in engine.stage_megabatch(store, [0, 1]).items()}
    with pytest.raises(ValueError, match="row-local"):
        engine.preprocess_megabatch(pages)
    # the produce surfaces degrade to solo launches instead
    assert len(engine.produce_batches(store, [0, 1])) == 2
    assert [p for p, _ in engine.produce_stream(store, [0, 1], megabatch=2)] == [0, 1]


# -- engines share nothing -------------------------------------------------------------


def test_engines_of_one_signature_run_their_own_plans(monkeypatch):
    """A stage patched on one engine's plan runs for that engine alone, on
    the produce path and on the block cache's rest program."""
    spec, store = _fixture(rows=128, partitions=2)
    e1, e2 = _engine(spec), _engine(spec)
    assert e1.cache_signature() == e2.cache_signature()
    calls = []
    stage = next(st for st in e2.lowered_plan.stages if st.family == "dense")
    real = stage.fn

    def traced(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(stage, "fn", traced)
    e1.produce_batch(store, 0)
    list(e1.produce_stream(store, [0, 1], megabatch=2))
    pages = {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32))
             for k, v in e1.stage_partition(store, 0).items()}
    e1._preprocess_rest(pages)
    assert calls == []
    e2.produce_batch(store, 0)
    e2._preprocess_rest(pages)
    assert calls == [1, 1]


def test_dropped_engine_is_collected():
    """Nothing process-wide keeps an engine, its plan or its batches alive."""
    spec, store = _fixture(rows=128, partitions=2)
    engine = _engine(spec)
    engine.produce_batch(store, 0)
    list(engine.produce_stream(store, [0, 1], megabatch=2))
    refs = (weakref.ref(engine), weakref.ref(engine.lowered_plan))
    del engine
    gc.collect()
    assert all(r() is None for r in refs)
