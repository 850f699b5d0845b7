"""Whole runs of each kind of cell on the CPU at small shapes, with the
look for a card skipped: what a sound run reports, that each planted fault
of the timed path (an answer altered where it is produced, half the batch
left out with the mean over the rest, a step that leaves the state
unchanged) turns ``correct`` false, that the control fails the limits, and
that each window ends in a device sync."""

import time

import pytest
import torch

from presto_bench.conftest import SMALL_LIMITS, small_files
from presto_bench.harness import cells, check, common, control, inputs

SEED = 2**33 + 5
CPU = torch.device("cpu")


def _run(cell, trace=False, **traffic):
    f = small_files(cell, **traffic)
    f["limits"] = {k: v for k, v in SMALL_LIMITS.items() if k in f["limits"]}
    return cells.run_cell(cell, SEED, 0.5, trace, CPU, time.perf_counter(), files=f)


@pytest.mark.parametrize("cell", ["rm2-isp", "rm2-isp-dedup4", "rm2-train-fed", "rm1-train-fed"])
def test_a_sound_run(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    if "train" in cell:
        assert set(r["metrics"]) == {"train_samples_per_s", "train_step_p95_ms", "setup_s"}
    else:
        assert set(r["metrics"]) == {"isp_samples_per_s", "isp_batch_p95_ms", "setup_s"}
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def _alter_one_id(monkeypatch):
    from repro_torch.core import presto

    real = presto.execute_plan

    def altered(plan, pages):
        mb = real(plan, pages)
        mb["one_hot_ids"] = mb["one_hot_ids"].clone()
        mb["one_hot_ids"][0, 0] += 1
        return mb

    monkeypatch.setattr(presto, "execute_plan", altered)


@pytest.mark.parametrize("cell", ["rm2-isp", "rm2-train-fed"])
def test_an_answer_altered_where_produced(cell, monkeypatch):
    _alter_one_id(monkeypatch)
    r = _run(cell)
    assert not r["correct"] and r["checks"]["batch_ids"]["value"] >= 1


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.launch import train

    real = train.recsys_step

    def halved(rcfg, lr, steps):
        opt, step = real(rcfg, lr, steps)

        def half(state, batch):
            rows = batch["labels"].shape[0] // 2
            return step(state, {k: v[:rows] for k, v in batch.items()})

        return opt, half

    monkeypatch.setattr(train, "recsys_step", halved)
    r = _run("rm2-train-fed")
    assert not r["correct"] and r["checks"]["loss"]["value"] > SMALL_LIMITS["loss"]


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from repro_torch.train import optimizer

    real = optimizer.adamw

    def frozen(*a, **k):
        opt = real(*a, **k)
        return optimizer.Optimizer(opt.init, lambda grads, state, params, *r, **kw: (
            state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}))

    monkeypatch.setattr(optimizer, "adamw", frozen)
    import repro_torch.launch.train as lt
    monkeypatch.setattr(lt, "adamw", frozen)
    r = _run("rm2-train-fed")
    assert not r["correct"] and r["checks"]["update"]["value"] == pytest.approx(1.0)


def test_the_control_fails_the_limits():
    f = small_files("rm2-isp")
    data = inputs.data_config(f["cfg"], f["traffic"])
    _, params = inputs.transform_spec(data, SEED)
    got = control.transform_control(lambda i: inputs.raw_partition(data, SEED, i), params, [0])
    assert not check.verdict(got, {"batch_ids": 0, "batch_dense": 1e-5})["correct"]


def test_each_window_ends_in_a_sync(monkeypatch):
    syncs, delivers = [], []
    real_sync = common.sync

    def counting_sync(device):
        syncs.append(time.perf_counter())
        real_sync(device)

    monkeypatch.setattr(cells.driver("train"), "sync", counting_sync)
    r = _run("rm2-train-fed")
    # every step of the window and of the set-up ends in a sync
    assert len(syncs) >= r["attempted"] + small_files("rm2-train-fed")["traffic"]["warmup_steps"]

    from repro_torch.core.presto import TorchPreStoEngine

    real_deliver = TorchPreStoEngine.deliver

    def counting_deliver(done):
        delivers.append(1)
        real_deliver(done)

    monkeypatch.setattr(TorchPreStoEngine, "deliver", staticmethod(counting_deliver))
    r = _run("rm2-isp", warmup_batches=0)
    assert len(delivers) == r["attempted"]  # the window waits for every batch it launched


def test_a_traced_run_needs_device_operations():
    with pytest.raises(RuntimeError, match="no device operation"):
        _run("rm2-isp", trace=True)


def test_the_result_names_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    info = common.device_info(torch.device("cuda", 0), 123)
    assert info == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                    "memory_peak_bytes": 123}


def test_the_driver_is_found_by_the_traffic_files_name():
    isp = cells.driver("isp")
    assert isp is cells.driver("isp") and callable(isp.run)
    assert isp.__file__ == str(cells.BENCH / "traffic" / "isp.py")
    assert isp.groups(8, 4) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert isp.groups(5, 2) == [[0, 1], [2, 3], [4, 0]]


@pytest.mark.parametrize("cell", ["rm2-isp", "rm2-isp-dedup4"])
def test_a_megabatched_isp_run(cell):
    """``megabatch`` in the traffic file: K partitions a launch, each of the
    K batches judged and counted."""
    r = _run(cell, megabatch=2, warmup_batches=4)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["attempted"] % 2 == 0


def test_a_train_run_with_the_feature_cache(monkeypatch):
    """``use_cache`` in the traffic file reaches the session."""
    from repro_torch.core import service

    seen = []
    real = service.PreprocessingService.submit

    def submit(self, job):
        seen.append(job.use_cache)
        return real(self, job)

    monkeypatch.setattr(service.PreprocessingService, "submit", submit)
    r = _run("rm1-train-fed", use_cache=True)
    assert seen == [True]
    assert r["correct"], r["checks"]


def test_the_sample_is_drawn_from_the_seed():
    def kept(seed):
        s = inputs.Sample(seed, 5)
        for i in range(10_000):
            s.offer(i)
        return s.items

    assert kept(SEED) == kept(SEED) != kept(SEED + 1)
    assert len(kept(SEED)) == 5 and max(kept(SEED)) > 1000  # not just the stream's head
    assert inputs.chosen_files(SEED, 8, 2) == inputs.chosen_files(SEED, 8, 2)
