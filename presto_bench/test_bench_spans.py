"""The program's spans as the benchmark reads them, and the readers of
``copy_in_host_us.isp``, ``transform_host_us.isp``, ``glue_us.isp`` and
``step_gap_ms.train``: the spans of one ``TorchPreStoEngine.launch`` in an
exported trace on the CPU, and each reader on synthetic Chrome events (in
the format of ``test_bench_trace.py``) with answers worked by hand."""

import dataclasses

import pytest
from torch.profiler import ProfilerActivity, profile

from presto_bench.harness.common import read_trace, reader
from presto_bench.harness.trace import TraceView
from presto_bench.test_bench_trace import _launch, _x, isp_events, train_events

MAIN, WORKER, AUTOGRAD = (1, 10), (1, 20), (1, 11)
NEW_READERS = ["copy_in_host_us.isp", "transform_host_us.isp", "glue_us.isp",
               "step_gap_ms.train"]
GLUE = ("opgraph.gen_words", "opgraph.form_batch", "preprocess.dedup_expand",
        "preprocess.flatten_megabatch", "ops.hash_params")


def _spans(tv: TraceView):
    """Every range of the trace as (start, end, name), of its one thread."""
    (ranges,) = [r for r in tv.ranges.values() if any(n == "engine.launch" for *_, n in r)]
    return ranges


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("dup_factor", [1, 4])
def test_engine_launch_spans_nest(dup_factor):
    """One launch of a small spec: ``engine.launch`` holds ``engine.copy_in``
    and ``engine.transform``, which holds the glue spans; dedup pages add
    the expand."""
    from repro_torch.configs.registry import get_recsys
    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.data.synth import SyntheticRecSysSource

    data = dataclasses.replace(get_recsys("rm1", reduced=True).data, rows_per_partition=128,
                               dup_factor=dup_factor)
    src = SyntheticRecSysSource(data, seed=3)
    engine = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    pinned = engine.pin_pages(engine.stage_megabatch(PartitionedStore(1, 1, src), [0]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.launch(pinned)
    spans = _spans(read_trace(prof))
    by = {}
    for r in spans:
        by.setdefault(r[2], []).append(r)
    (launch,), (copy_in,), (transform,) = (by["engine.launch"], by["engine.copy_in"],
                                           by["engine.transform"])
    assert _inside(copy_in, launch) and _inside(transform, launch)
    assert copy_in[1] <= transform[0]
    want = {"opgraph.gen_words", "opgraph.form_batch", "preprocess.flatten_megabatch",
            "ops.hash_params"} | ({"preprocess.dedup_expand"} if dup_factor > 1 else set())
    assert {n for n in GLUE if n in by} == want
    for name in want:
        assert all(_inside(r, transform) for r in by[name])
    assert len(by["ops.hash_params"]) == 2  # fused_sparse's and fused_gen's


def isp_span_events():
    """Two batches.  Each: ``engine.launch`` [0, 100) holding
    ``engine.copy_in`` [5, 25) (an H2D copy of 100 us) and
    ``engine.transform`` [30, 90), which launches fused_dense (10 us) outside
    any glue span and, inside ``opgraph.gen_words``, ``ops.hash_params`` and
    ``opgraph.form_batch``, a gather (3), a cat (2) and a transpose (30)."""
    ev = []
    for b, base in enumerate((0, 1000)):
        corr = 100 * b
        ev += [_x("user_annotation", "engine.launch", base, 100, MAIN),
               _x("cpu_op", "engine.copy_in", base + 5, 20, MAIN),
               _x("cpu_op", "engine.transform", base + 30, 60, MAIN),
               _x("cpu_op", "opgraph.gen_words", base + 31, 4, MAIN),
               _x("cpu_op", "ops.hash_params", base + 40, 3, MAIN),
               _x("cpu_op", "opgraph.form_batch", base + 70, 15, MAIN)]
        dev = 5000 + 400 * b
        ev += _launch(MAIN, base + 10, corr + 1, "Memcpy HtoD (Pinned -> Device)", dev, 100,
                      "gpu_memcpy")
        ev += _launch(MAIN, base + 32, corr + 2, "vectorized_gather_kernel", dev + 100, 3)
        ev += _launch(MAIN, base + 41, corr + 3, "CatArrayBatchedCopy", dev + 103, 2)
        ev += _launch(MAIN, base + 50, corr + 4, "fused_dense_kernel(uint4 const*)", dev + 105,
                      10)
        ev += _launch(MAIN, base + 75, corr + 5, "elementwise_kernel", dev + 115, 30)
    return ev


def test_isp_span_readers():
    tv = TraceView(isp_span_events())
    ctx = {"kind": "isp", "trace": tv, "trace_ranges": tv, "trace_units": 2}
    assert reader("copy_in_host_us.isp")(ctx) == pytest.approx(20.0)
    assert reader("transform_host_us.isp")(ctx) == pytest.approx(60.0)
    assert reader("glue_us.isp")(ctx) == pytest.approx(3 + 2 + 30)
    # the glue is a part of the kernels' busy time
    assert reader("glue_us.isp")(ctx) <= reader("transform_busy_us.isp")(ctx)


def train_step_events():
    """Three ``pipeline.step`` spans on the main thread.  Step 1 runs on the
    device over [1000, 1110) (its last operation, the metrics' DtoH, ends at
    1110), step 2 over [1200, 1280), step 3 from 1330.  In the first gap a
    pool worker's copy runs [1130, 1150) (its launch unseen); the autograd
    thread's kernel [1275, 1290) reaches into the second.  The idle time is
    90 - 20 = 70 us, then 50 - 10 = 40 us: 55 us a pair."""
    ev = [_x("user_annotation", "pipeline.step", s, 100, MAIN) for s in (0, 200, 400)]
    ev += _launch(MAIN, 10, 1, "embedding_bag_kernel", 1000, 50)
    ev += _launch(MAIN, 50, 2, "multi_tensor_apply_kernel", 1060, 40)
    ev += _launch(MAIN, 90, 3, "Memcpy DtoH (Device -> Pageable)", 1105, 5, "gpu_memcpy")
    ev.append(_x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1130, 20))
    ev += _launch(MAIN, 210, 4, "gemm_kernel", 1200, 50)
    ev += _launch(AUTOGRAD, 215, 5, "compute_grad_weight_bags", 1275, 15)
    ev += _launch(MAIN, 290, 6, "Memcpy DtoH (Device -> Pageable)", 1260, 20, "gpu_memcpy")
    ev += _launch(MAIN, 410, 7, "embedding_bag_kernel", 1330, 70)
    # a worker's launch outside any step: it opens no step
    ev += _launch(WORKER, 150, 8, "fused_sparse_kernel", 1500, 10)
    return ev


def test_step_gap_reader_counts_only_idle_time_between_steps():
    tv = TraceView(train_step_events())
    ctx = {"kind": "train", "trace": tv, "trace_ranges": tv, "trace_units": 3}
    assert reader("step_gap_ms.train")(ctx) == pytest.approx(55e-3)


def test_step_gap_reader_needs_two_steps_with_work():
    one = [e for e in train_step_events() if not (e["name"] == "pipeline.step" and e["ts"])]
    ctx = {"kind": "train", "trace_ranges": TraceView(one), "trace_units": 1}
    assert reader("step_gap_ms.train")(ctx) is None


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_readers_find_nothing_without_a_trace(name):
    ctx = {"kind": "isp", "trace": None, "trace_ranges": None, "trace_units": 2}
    assert reader(name)(ctx) is None
    assert reader(name)({"kind": "train"}) is None


@pytest.mark.parametrize("name", NEW_READERS)
def test_new_readers_find_nothing_in_a_trace_without_the_spans(name):
    """A program without the spans (the benchmark's earlier traces) gives no
    reading, not a zero."""
    for events in (isp_events(), train_events()):
        tv = TraceView(events)
        ctx = {"kind": "isp", "trace": tv, "trace_ranges": tv, "trace_units": 2}
        assert reader(name)(ctx) is None
