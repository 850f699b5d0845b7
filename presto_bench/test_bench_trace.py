"""The trace reader and every per-layer metric's reader on synthetic
profiler traces, in the Chrome format ``torch.profiler`` exports."""

import json

import pytest

from presto_bench.harness import counts
from presto_bench.harness.common import reader
from presto_bench.harness.files import BENCH
from presto_bench.harness.trace import TraceView

MAIN, AUTOGRAD = (1, 10), (1, 11)


def _x(cat, name, ts, dur, tid=None, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0 if tid is None else tid[0], "tid": 7 if tid is None else tid[1], "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _launch(thread, ts, corr, device_name, dev_ts, dev_dur, cat="kernel"):
    return [_x("cuda_runtime", "cudaLaunchKernel", ts, 2, thread, corr),
            _x(cat, device_name, dev_ts, dev_dur, None, corr)]


def train_events():
    """One step: the bag's forward (10 us of kernels), the MLPs (20), the
    bag's backward on the autograd thread (30), then AdamW (100); idle gaps
    of 5, 5 and 10 us between them."""
    ev = [_x("user_annotation", "dlrm.embedding_bag", 0, 20, MAIN),
          _x("cpu_op", "aten::mm", 20, 10, MAIN),
          _x("cpu_op", "autograd::engine::evaluate_function: EmbeddingBagBackward0", 30, 10,
             AUTOGRAD),
          _x("user_annotation", "adamw", 40, 30, MAIN)]
    ev += _launch(MAIN, 5, 1, "embedding_bag_kernel", 100, 10)
    ev += _launch(MAIN, 22, 2, "gemm_kernel", 115, 20)
    ev += _launch(AUTOGRAD, 32, 3, "compute_grad_weight_bags", 140, 30)
    ev += _launch(MAIN, 45, 4, "multi_tensor_apply_kernel", 180, 100)
    ev.append({"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1, "pid": 0, "tid": 0})
    return ev


def isp_events():
    """Two batches: an H2D copy (100 us each) then fused_dense, fused_sparse
    and fused_gen (10, 20, 4 us) and a gather (3 us), all back to back but
    for a 13 us gap before the second batch."""
    ev, t, corr = [], 0, 0
    for _ in range(2):
        for name, dur, cat in (("Memcpy HtoD (Pinned -> Device)", 100, "gpu_memcpy"),
                               ("(anonymous namespace)::fused_dense_kernel(uint4 const*)", 10,
                                "kernel"),
                               ("(anonymous namespace)::fused_sparse_kernel(unsigned int*)", 20,
                                "kernel"),
                               ("fused_gen_kernel(uint4 const*)", 4, "kernel"),
                               ("vectorized_gather_kernel", 3, "kernel")):
            corr += 1
            ev += _launch(MAIN, t, corr, name, t + 1, dur, cat)
            t += dur
        t += 13
    return ev


def test_trace_view_sums_and_attribution():
    tv = TraceView(train_events())
    assert tv.busy_s() == pytest.approx(160e-6)
    assert tv.time_under_s(lambda n: n == "adamw") == pytest.approx(100e-6)
    assert tv.time_under_s(lambda n: n.startswith("autograd::")) == pytest.approx(30e-6)
    assert tv.top_ops(1) == [["multi_tensor_apply_kernel", pytest.approx(100e-6)]]
    gaps = dict((k, v) for k, v in tv.idle_gaps())
    assert gaps == {"adamw": pytest.approx(10e-6), "aten::mm": pytest.approx(5e-6),
                    "autograd::engine::evaluate_function: EmbeddingBagBackward0":
                        pytest.approx(5e-6)}


def test_trace_view_loads_exported_json(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": isp_events()}))
    assert TraceView.load(str(path)).busy_s() == pytest.approx(2 * 137e-6)


def test_train_readers():
    model = json.loads((BENCH / "configs" / "rm2.json").read_text())
    tv = TraceView(train_events())
    ctx = {"kind": "train", "trace": tv, "trace_ranges": tv, "trace_units": 1,
           "trace_window_s": 200e-6, "model": model["model"], "data": model["data"],
           "units": 4, "rows": 4 * 8192, "window_s": 0.8, "intervals_s": [0.2] * 4,
           "produce_s": 0.6, "produced": 3, "feed_wait_s": 0.004, "setup_s": 12.5}
    assert reader("embedding_ms.train")(ctx) == pytest.approx(40e-3)
    assert reader("optimizer_ms.train")(ctx) == pytest.approx(100e-3)
    assert reader("optimizer_roofline.train")(ctx) == pytest.approx(
        counts.optimizer_floor_s(model["model"], model["data"]) / 100e-6 * 100)
    # 160 us busy in a traced stretch of 200 us
    assert reader("device_idle.train")(ctx) == pytest.approx((1 - 160e-6 / 200e-6) * 100)
    assert reader("produce_ms.train")(ctx) == pytest.approx(200.0)
    assert reader("feed_wait_ms.train")(ctx) == pytest.approx(1.0)
    assert reader("train_samples_per_s")(ctx) == pytest.approx(40960.0)
    assert reader("train_step_p95_ms")(ctx) == pytest.approx(200.0)
    assert reader("setup_s")(ctx) == 12.5
    assert reader("train_step_mfu")(ctx) == pytest.approx(
        counts.train_step_flops(model["model"], model["data"], 8192) / (0.2 * 67e12) * 100)


def test_isp_readers():
    model = json.loads((BENCH / "configs" / "rm2.json").read_text())
    tv = TraceView(isp_events())
    ctx = {"kind": "isp", "trace": tv, "trace_ranges": tv, "trace_units": 2,
           "trace_window_s": 300e-6, "data": model["data"], "dup_factor": 1,
           "units": 3, "rows": 3 * 8192, "window_s": 0.003,
           "latency_s": [0.002, 0.004, 0.003], "launch_s": [1e-4, 2e-4, 3e-4], "setup_s": 9.0}
    assert reader("h2d_ms.isp")(ctx) == pytest.approx(0.1)
    assert reader("transform_busy_us.isp")(ctx) == pytest.approx(37.0)
    assert reader("device_idle.isp")(ctx) == pytest.approx((1 - 2 * 137e-6 / 300e-6) * 100)
    assert reader("launch_host_us.isp")(ctx) == pytest.approx(200.0)
    assert reader("isp_samples_per_s")(ctx) == pytest.approx(8192 * 1000)
    assert reader("isp_batch_p95_ms")(ctx) == pytest.approx(4.0)
    floors = sum(counts.floor_s(c) for c in counts.transform_kernel_costs(
        model["data"], 8192).values())
    assert reader("transform_roofline.isp")(ctx) == pytest.approx(
        2 * floors / (2 * 34e-6) * 100)


@pytest.mark.parametrize("name", ["embedding_ms.train", "optimizer_ms.train",
                                  "optimizer_roofline.train", "h2d_ms.isp",
                                  "transform_roofline.isp", "device_idle.isp"])
def test_readers_find_nothing_without_a_trace(name):
    ctx = {"kind": "isp", "trace": None, "trace_ranges": None, "data": {}, "dup_factor": 1}
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("name", ["device_idle.isp", "device_idle.train"])
def test_idle_is_a_share_of_the_one_stretch(name):
    """Busy time and length come from the same traced stretch, so the share
    lies in [0, 100] whatever the window read: 0 for a stretch busy
    throughout, 100 less the busy share otherwise."""
    tv = TraceView(isp_events())
    busy = tv.busy_s()
    for window_s, units in ((1e-9, 1), (1e3, 10**6)):  # the window's own clock plays no part
        ctx = {"kind": "isp", "trace": tv, "trace_units": 2, "trace_window_s": busy,
               "units": units, "window_s": window_s}
        assert reader(name)(ctx) == pytest.approx(0.0, abs=1e-9)
        ctx["trace_window_s"] = 4 * busy
        assert reader(name)(ctx) == pytest.approx(75.0)
