"""The port's spans (``common.util.span``) and the pool workers' counters.

A span is a ``torch.profiler`` host range only while the calling thread's
profiler runs; otherwise it is one shared no-op context.  The existing
ranges (``adamw``, ``adafactor``, ``dlrm.embedding_bag``) keep their names
on it, and ``TrainingPipeline.run_session`` marks each step
(``pipeline.step``).  The pool workers, which the profiler does not see,
split their produce seconds into staging and the wait in
``engine.deliver`` (``SessionStats.stage_time_s``, ``deliver_wait_s``).
The spans of ``TorchPreStoEngine.launch`` and the Transform's glue are
checked, and read, in ``presto_bench/test_bench_spans.py``.
"""

import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.common.util import NO_SPAN, span
from repro_torch.configs.registry import get_recsys
from repro_torch.core.pipeline import TrainingPipeline
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.service import JobSpec, PreprocessingService
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.models import recsys as RS
from repro_torch.train import adafactor, adamw, init_state, make_train_step, warmup_cosine

ROWS = 128


def _names(prof) -> list:
    return [e.name for e in prof.events()]


@pytest.fixture(scope="module")
def small():
    cfg = get_recsys("rm1", reduced=True)
    src = SyntheticRecSysSource(dataclasses.replace(cfg.data, rows_per_partition=ROWS), seed=5)
    return cfg, src, TransformSpec.from_source(src)


def test_span_is_the_shared_noop_without_a_profiler():
    assert span("engine.launch") is NO_SPAN
    assert span("pipeline.step") is NO_SPAN
    with span("a"), span("a"):  # reusable and reentrant
        pass


def test_span_records_on_the_profiled_thread_only():
    got = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer.span"):
            assert span("inner.span") is not NO_SPAN
            with span("inner.span"):
                torch.ones(4).sum()
        worker = threading.Thread(target=lambda: got.append(span("worker.span")))
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive() and got == [NO_SPAN]
    events = {e.name: e for e in prof.events()}
    outer, inner = events["outer.span"], events["inner.span"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert "worker.span" not in events


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_moved_ranges_keep_their_names(small, opt_name):
    cfg, src, spec = small
    engine = TorchPreStoEngine(spec, device="cpu")
    batch = engine.produce_batch(PartitionedStore(1, 1, src), 0)
    opt = (adamw if opt_name == "adamw" else adafactor)(warmup_cosine(1e-3, 2, 10))
    model = RS.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    state = init_state(model, opt)
    step = make_train_step(lambda m, b: RS.loss_fn(m, b, cfg), opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    names = _names(prof)
    assert "dlrm.embedding_bag" in names and opt_name in names


def test_pipeline_step_spans_hold_each_step(small):
    _, src, spec = small
    engine = TorchPreStoEngine(spec, device="cpu")

    def train_step(state, mb):
        return state + 1, {"loss": mb["labels"].sum()}

    with PreprocessingService(num_workers=2) as service:
        session = service.submit(JobSpec(name="spans", partitions=range(3), engine=engine,
                                         store=PartitionedStore(3, 1, src), units=2))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, stats, _ = TrainingPipeline(train_step=train_step).run_session(0, session)
    assert state == stats.steps == 3
    steps = [e for e in prof.events() if e.name == "pipeline.step"]
    assert len(steps) == 3 and len({e.thread for e in steps}) == 1
    sums = [e for e in prof.events() if e.name == "aten::sum" and e.thread == steps[0].thread]
    assert len(sums) == 3
    for s in sums:  # every step's work lies inside one step's span
        assert sum(st.time_range.start <= s.time_range.start <= st.time_range.end
                   for st in steps) == 1


@pytest.mark.parametrize("megabatch", [1, 2])
def test_session_counters_split_produce_time(small, tmp_path, megabatch):
    """A session over partitions on disk: staging and the deliver wait are
    parts of the workers' produce seconds."""
    _, src, spec = small
    store = PartitionedStore(6, 2, src, root=str(tmp_path))
    store.materialize(range(6))
    engine = TorchPreStoEngine(spec, device="cpu")
    with PreprocessingService(num_workers=2) as service:
        session = service.submit(JobSpec(name="counters", partitions=range(6), engine=engine,
                                         store=store, units=2, megabatch=megabatch))
        got = sum(1 for _ in session)
        st = session.stats()
    assert got == st.produced == 6
    assert st.stage_time_s > 0 and st.deliver_wait_s >= 0
    assert st.stage_time_s + st.deliver_wait_s <= st.produce_time_s + 1e-9
