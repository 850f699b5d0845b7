"""The port's control-side modules against the JAX package's: the megabatch
tuner, the control plane, the pool planner and the cost models.

They hold no tensors, so the port computes what the reference computes on
the same inputs: equal ladders, tuner trajectories, pool plans, autoscaler
decisions, and TCO and energy figures equal to 1e-12 relative.  The cases
of the reference's own tests that need no service run here on the port.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import autotune as jautotune
from repro.core import costmodel as jcost
from repro.core import ctrlplane as jctrl
from repro.core import planner as jplanner
from repro_torch.core import autotune, costmodel, ctrlplane, planner
from repro_torch.core.autotune import MegabatchTuner, k_ladder
from repro_torch.core.costmodel import DEFAULT_PLACEMENT_MODEL
from repro_torch.core.ctrlplane import (
    Autoscaler,
    AutoscalePolicy,
    EventLog,
    FailureInjector,
    SessionCheckpoint,
    SimulatedFailure,
    parse_kill_spec,
)
from repro_torch.core.planner import (
    AdmissionError,
    DeviceTopology,
    SloRequest,
    effective_demand_units,
    measure_throughput,
    plan_pool,
    plan_pool_slo,
    qos_demand_units,
)
from repro_torch.data.loader import WorkQueue


def _drive(tuner, cost_of, iters: int = 64):
    for _ in range(iters):
        if tuner.converged:
            break
        k = tuner.k
        tuner.record(k, cost_of(k) * k)
    assert tuner.converged, "tuner failed to converge within the iteration cap"
    return tuner


# -- autotune (test_autotune.py, on the port) ----------------------------------------


def test_k_ladder_powers_of_two():
    assert k_ladder(1) == [1]
    assert k_ladder(2) == [1, 2]
    assert k_ladder(8) == [1, 2, 4, 8]
    assert k_ladder(12) == [1, 2, 4, 8]
    assert k_ladder(0) == [1]
    for k in range(0, 70):
        assert k_ladder(k) == jautotune.k_ladder(k)


def test_predicted_megabatch_k_knee():
    model = DEFAULT_PLACEMENT_MODEL
    assert model.predicted_megabatch_k(10.0, 8) == 1
    assert model.predicted_megabatch_k(1e-7, 8) == 8
    ks = [model.predicted_megabatch_k(pps, 8) for pps in (1e-7, 1e-5, 1e-3, 1e-1, 10.0)]
    assert ks == sorted(ks, reverse=True)
    assert model.predicted_megabatch_k(1e-7, 8, candidates=[1, 2]) == 2
    for pps in np.geomspace(1e-8, 10.0, 25):
        assert model.predicted_megabatch_k(pps, 16) == \
            jcost.DEFAULT_PLACEMENT_MODEL.predicted_megabatch_k(pps, 16)


def test_qos_demand_units_clamps_and_caps():
    assert qos_demand_units(1000.0, 0.0) == 1
    assert qos_demand_units(1000.0, 100.0) == 10
    assert qos_demand_units(50.0, 100.0) == 1
    assert qos_demand_units(1e9, 1.0, cap=64) == 64


def test_tuner_seeds_from_cost_model():
    assert MegabatchTuner(8, per_partition_s=1e-7).seeded_k == 8
    assert MegabatchTuner(8, per_partition_s=10.0).seeded_k == 1
    assert MegabatchTuner(8).seeded_k == 1


def test_tuner_climbs_monotone_decreasing_cost():
    assert _drive(MegabatchTuner(8), lambda k: 1.0 / k).k == 8


def test_tuner_converges_at_one_for_increasing_cost():
    t = _drive(MegabatchTuner(8), lambda k: float(k))
    assert t.k == 1
    assert t.arm_cost(4) is None and t.arm_cost(8) is None


def test_tuner_finds_interior_optimum():
    costs = {1: 1.0, 2: 0.4, 4: 0.8, 8: 1.2}
    assert _drive(MegabatchTuner(8), costs.__getitem__).k == 2


def test_tuner_frozen_after_convergence():
    t = _drive(MegabatchTuner(8), lambda k: 1.0 / k)
    k = t.k
    for _ in range(8):
        assert t.record(k, 100.0 * k) is False
    assert t.k == k and t.converged


def test_tuner_ignores_off_ladder_and_foreign_launches():
    t = MegabatchTuner(8)
    assert t.k == 1
    assert t.record(3, 1.0) is False
    assert t.arm_cost(3) is None
    assert t.record(0, 1.0) is False and t.record(1, -1.0) is False
    for _ in range(8):
        assert t.record(2, 1.0) is False
    assert t.k == 1 and t.arm_cost(2) == pytest.approx(0.5)


def test_tuner_move_cap_freezes_oscillation():
    t = MegabatchTuner(2, max_moves=0)
    _drive(t, {1: 1.0, 2: 5.0}.__getitem__)
    assert t.converged and t.moves == 0 and t.k == 2


def test_tuner_summary_reports_measured_arms():
    s = _drive(MegabatchTuner(4), lambda k: 1.0 / k).summary()
    assert s["k"] == 4 and s["converged"] is True
    assert set(s["arms"]) == {1, 2, 4}
    assert all(a["samples"] >= 1 for a in s["arms"].values())


@pytest.mark.parametrize("seed", range(6))
def test_tuner_trajectory_equals_reference(seed):
    """One seeded cost sequence (noisy, with off-ladder tails and foreign
    rungs) moves both packages' tuners through the same K at every step,
    and a restored summary resumes both alike."""
    rng = np.random.default_rng(seed)
    base = {k: float(c) for k, c in zip([1, 2, 4, 8, 16], rng.uniform(0.2, 2.0, 5))}
    kw = dict(per_partition_s=float(rng.choice([0.0, 1e-6, 1e-3])) or None,
              min_samples=int(rng.integers(1, 4)), rel_tolerance=0.05)
    ours, theirs = MegabatchTuner(16, **kw), jautotune.MegabatchTuner(16, **kw)
    for _ in range(80):
        assert ours.k == theirs.k
        k = ours.k if rng.random() > 0.15 else int(rng.choice([3, 2, 16, 0]))
        launch_s = base.get(k, 1.0) * max(k, 1) * float(rng.uniform(0.9, 1.1))
        assert ours.record(k, launch_s) == theirs.record(k, launch_s)
    assert ours.summary() == theirs.summary()
    assert ours.converged == theirs.converged and ours.moves == theirs.moves
    a, b = MegabatchTuner(16), jautotune.MegabatchTuner(16)
    a.restore(ours.summary())
    b.restore(theirs.summary())
    assert a.summary() == b.summary()


def test_workqueue_device_index_fifo_and_fallback():
    q = WorkQueue(range(8), owner_of=lambda pid: pid % 2)
    assert [q.claim(prefer_device=0) for _ in range(4)] == [0, 2, 4, 6]
    assert q.claim(prefer_device=0) is None
    assert q.claim(prefer_device=0, fallback_ok=lambda p: True) == 1
    assert q.claim(prefer_device=1) == 3
    assert sorted(q.claim() for _ in range(2)) == [5, 7]
    assert q.claim() is None and q.remaining() == 8
    for pid in range(8):
        assert q.complete(pid)
    assert q.exhausted and q.remaining() == 0


def test_workqueue_peek_ahead_is_non_claiming_and_ordered():
    q = WorkQueue(range(8), owner_of=lambda pid: pid % 2)
    assert q.peek_ahead(3, prefer_device=1) == [1, 3, 5]
    assert q.peek_ahead(6, prefer_device=1) == [1, 3, 5, 7, 0, 2]
    assert q.peek_ahead(100) == list(range(8))
    assert q.peek_ahead(0) == []
    assert q.remaining() == 8
    assert sorted(q.claim() for _ in range(8)) == list(range(8))
    assert q.peek_ahead(8) == []


def test_workqueue_peek_tracks_claims():
    q = WorkQueue(range(6))
    assert q.is_pending(0)
    q.claim()
    assert not q.is_pending(0)
    assert q.pending_snapshot() == [1, 2, 3, 4, 5]
    assert q.peek_ahead(2) == [1, 2]


# -- control plane (test_ctrlplane.py, on the port) -------------------------------------


def test_eventlog_bounded_ring_counts_and_cursor(tmp_path):
    import json

    log = EventLog(capacity=4)
    for i in range(10):
        log.emit("tick", i=i)
    log.emit("other")
    assert log.emitted == 11
    assert log.counts() == {"tick": 10, "other": 1}
    tail = log.tail(2)
    assert [e.kind for e in tail] == ["tick", "other"]
    assert tail[0].data == {"i": 9}
    assert [e.kind for e in log.tail(10, kind="tick")] == ["tick"] * 3
    assert [e.seq for e in log.since(8)] == [9, 10]
    assert log.since(10) == []
    summ = log.summary(tail=2)
    assert summ["emitted"] == 11 and summ["dropped"] == 7
    assert [e["kind"] for e in summ["tail"]] == ["tick", "other"]
    out = tmp_path / "events.json"
    log.dump(str(out))
    assert [e["seq"] for e in json.loads(out.read_text())] == [7, 8, 9, 10]


def test_failure_injector_and_kill_spec():
    log = EventLog()
    inj = FailureInjector(fail_at=3, events=log)
    inj.check(0)
    with pytest.raises(SimulatedFailure, match="simulated failure at step 3"):
        inj.check(3)
    inj.check(3)
    assert inj.fired and log.counts() == {"failure_injected": 1}
    assert FailureInjector(fail_at=None).check(0) is None
    assert parse_kill_spec("2@15") == (15, 2) == jctrl.parse_kill_spec("2@15")
    with pytest.raises(ValueError):
        parse_kill_spec("2:15")


def test_checkpoint_save_is_atomic_and_load_rejects_torn(tmp_path):
    import os

    ck = SessionCheckpoint(job="j", partitions=[0, 1, 2], delivered=[0],
                           stats={"delivered": 1})
    path = str(tmp_path / "ck.json")
    ck.save(path)
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    got = SessionCheckpoint.load(path)
    assert got.job == "j" and got.delivered == [0] and got.remaining() == [1, 2]
    # the reference reads the port's checkpoint, field for field
    assert jctrl.SessionCheckpoint.load(path).to_dict() == got.to_dict()
    raw = open(path).read()
    with open(path, "w") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match="torn or truncated"):
        SessionCheckpoint.load(path)
    with open(path, "w") as f:
        f.write("[1, 2, 3]")
    with pytest.raises(ValueError):
        SessionCheckpoint.load(path)


class _FakeService:
    """The surface the autoscaler drives: load, membership, events."""

    def __init__(self, events, loads, workers=1):
        self.events, self._loads, self.num_workers = events, list(loads), workers
        self.closed = False

    def load_snapshot(self):
        snap = dict(self._loads[0])
        if len(self._loads) > 1:
            self._loads.pop(0)
        return dict(snap, workers=self.num_workers)

    def add_worker(self):
        self.num_workers += 1

    def remove_worker(self):
        if self.num_workers <= 1:
            return None
        self.num_workers -= 1
        return self.num_workers


def test_autoscaler_decisions_equal_reference():
    loads = ([{"backlog": 20, "demand_units": 6, "sessions": 2}] * 6
             + [{"backlog": 3, "demand_units": 6, "sessions": 1}] * 3
             + [{"backlog": 0, "demand_units": 0, "sessions": 0}] * 6)
    policy = dict(min_workers=1, max_workers=5, backlog_per_worker=2.0, max_step=2)
    ours = _FakeService(EventLog(), loads)
    theirs = _FakeService(jctrl.EventLog(), loads)
    a = Autoscaler(ours, AutoscalePolicy(**policy))
    b = jctrl.Autoscaler(theirs, jctrl.AutoscalePolicy(**policy))
    deltas = [(a.step(), b.step()) for _ in range(len(loads))]
    assert all(x == y for x, y in deltas)
    assert [d for d, _ in deltas][:3] == [2, 2, 0]  # grows to the 5-worker cap
    assert ours.num_workers == theirs.num_workers == 1  # drained back to the floor
    assert ours.events.counts() == theirs.events.counts()
    assert ours.events.counts()["scale_up"] == 2
    assert a.desired({"backlog": 9, "demand_units": 3, "sessions": 1, "workers": 1}) == 3


# -- planner ---------------------------------------------------------------------------


def test_effective_demand_units_discount():
    assert effective_demand_units(8, 0.0) == 8
    assert effective_demand_units(8, 0.5) == 4
    assert effective_demand_units(8, 1.0) == 1
    assert effective_demand_units(3, 0.5) == 2
    assert effective_demand_units(4, 2.0) == 1


def test_plan_pool_discounts_hot_jobs_toward_cold_ones():
    assert plan_pool(8, {"hot": 6, "cold": 6}).shares == {"hot": 4, "cold": 4}
    plan = plan_pool(8, {"hot": 6, "cold": 6}, {"hot": 2 / 3, "cold": 0.0})
    assert plan.effective_demand == {"hot": 2, "cold": 6}
    assert plan.shares == {"hot": 2, "cold": 6}
    assert not plan.oversubscribed
    assert plan.demand_units == {"hot": 6, "cold": 6}
    with pytest.raises(AdmissionError):
        plan_pool(1, {"a": 1, "b": 1})


def test_plan_pool_learns_device_topology():
    topo = DeviceTopology.round_robin(4, 2)
    assert topo.units_per_device == {0: 2, 1: 2}
    assert topo.total_units == 4 and topo.manned == {0, 1}
    plan = plan_pool(4, {"hot": 4, "cold": 4}, topology=topo,
                     device_weights={"hot": {0: 1.0}, "cold": {1: 1.0}})
    assert plan.device_shares == {0: {"hot": 2, "cold": 0}, 1: {"hot": 0, "cold": 2}}
    assert plan.device_utilized_units(0) == 2
    plan = plan_pool(4, {"a": 2, "b": 2}, topology=topo)
    assert plan.device_shares == {0: {"a": 1, "b": 1}, 1: {"a": 1, "b": 1}}
    assert plan_pool(4, {"a": 2}).device_shares is None


@pytest.mark.parametrize("seed", range(8))
def test_pool_plans_equal_reference(seed):
    """Random demands, hit rates, topologies and QoS mixes give the same
    plans and decisions in both packages."""
    rng = np.random.default_rng(seed)
    jobs = [f"j{i}" for i in range(int(rng.integers(1, 7)))]
    capacity = int(rng.integers(len(jobs), 3 * len(jobs) + 4))
    demand = {j: int(rng.integers(1, 12)) for j in jobs}
    hits = {j: float(rng.uniform(0, 1)) for j in jobs} if seed % 2 else None
    ndev = int(rng.integers(1, 5))
    topo_kw = {}
    if seed % 3:
        weights = {j: dict(enumerate(rng.dirichlet(np.ones(ndev)))) for j in jobs[::2]}
        topo_kw = dict(device_weights=weights)
    ours = plan_pool(capacity, demand, hits, topology=DeviceTopology.round_robin(capacity, ndev),
                     **topo_kw)
    theirs = jplanner.plan_pool(capacity, demand, hits,
                                topology=jplanner.DeviceTopology.round_robin(capacity, ndev),
                                **topo_kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    classes = ["rc", "exploratory"]
    reqs = [(j, demand[j], classes[int(rng.integers(0, 2))]) for j in jobs]
    cap = int(rng.integers(1, len(jobs) + 3))
    plan, dec = plan_pool_slo(cap, [SloRequest(*r) for r in reqs], hits)
    jplan, jdec = jplanner.plan_pool_slo(cap, [jplanner.SloRequest(*r) for r in reqs], hits)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert {k: dataclasses.asdict(v) for k, v in dec.items()} == \
        {k: dataclasses.asdict(v) for k, v in jdec.items()}


def test_paper_constants_equal_reference():
    assert planner.PAPER_CORES_REQUIRED_8GPU == jplanner.PAPER_CORES_REQUIRED_8GPU
    assert planner.PAPER_ISP_UNITS_REQUIRED_8GPU == jplanner.PAPER_ISP_UNITS_REQUIRED_8GPU
    for rm in planner.PAPER_CORES_REQUIRED_8GPU:
        assert planner.paper_speedup_per_unit(rm) == jplanner.paper_speedup_per_unit(rm)
    assert dataclasses.asdict(planner.ProvisioningPlan.derive(1000.0, 70.0)) == \
        dataclasses.asdict(jplanner.ProvisioningPlan.derive(1000.0, 70.0))


def test_measure_throughput_waits_for_the_output():
    """The step's output is waited for on its device (CPU tensors are done
    when the call returns); the rate counts every sample."""
    calls = []

    def step():
        calls.append(1)
        return {"loss": torch.ones(()), "parts": [torch.zeros(3)], "n": 3}

    m = measure_throughput(step, 64, iters=5, warmup=2)
    assert len(calls) == 7 and m.iters == 5 and m.wall_s > 0
    assert m.samples_per_s == pytest.approx(64 * 5 / m.wall_s)
    assert planner._cuda_devices({"a": torch.ones(2), "b": [torch.ones(1), "x"]}) == set()


# -- cost models -----------------------------------------------------------------------


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def test_tco_and_energy_equal_reference():
    assert set(costmodel.DEVICES) == set(jcost.DEVICES) - {"v5e-shard"}
    assert not hasattr(costmodel, "TPU_V5E_SHARD")
    for name, dev in costmodel.DEVICES.items():
        jdev = jcost.DEVICES[name]
        assert dataclasses.asdict(dev) == dataclasses.asdict(jdev)
        for units in (1, 3, 32):
            for hours in (1.0, 1000.0, costmodel.HOURS_3Y):
                for thr in (1.0, 7351.0, 4.2e6):
                    pairs = [
                        (costmodel.opex_usd(dev.power_w, hours), jcost.opex_usd(jdev.power_w, hours)),
                        (costmodel.tco_usd(dev, units, hours), jcost.tco_usd(jdev, units, hours)),
                        (costmodel.cost_efficiency(thr, dev, units, hours),
                         jcost.cost_efficiency(thr, jdev, units, hours)),
                        (costmodel.energy_kwh(dev, units, hours), jcost.energy_kwh(jdev, units, hours)),
                        (costmodel.energy_efficiency(thr, dev, units, hours),
                         jcost.energy_efficiency(thr, jdev, units, hours)),
                    ]
                    for a, b in pairs:
                        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("rm", ["rm1", "rm2", "rm3", "rm4", "rm5"])
def test_comparison_equals_reference(rm):
    args = (rm, 1e5, planner.PAPER_CORES_REQUIRED_8GPU[rm],
            planner.PAPER_ISP_UNITS_REQUIRED_8GPU[rm])
    ours, theirs = costmodel.Comparison(*args).summary(), jcost.Comparison(*args).summary()
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if isinstance(v, float):
            assert _rel(ours[k], v) <= 1e-12, k
        else:
            assert ours[k] == v, k


def test_contention_model_equals_reference():
    ours = costmodel.ContentionAwareCostModel(queue_threshold=3)
    theirs = jcost.ContentionAwareCostModel(queue_threshold=3)
    costs = costmodel.PartitionCosts(1e-3, 4e-3, 1e6, 1 << 20, 1 << 19)
    jcosts = jcost.PartitionCosts(1e-3, 4e-3, 1e6, 1 << 20, 1 << 19)
    for q in range(0, 10):
        assert ours.should_offload(costs, q) == theirs.should_offload(jcosts, q)
        assert ours.contended_isp_s(1e-3, q) == theirs.contended_isp_s(1e-3, q)
    assert math.isclose(costmodel.DEFAULT_CONTENTION_MODEL.queue_threshold,
                        jcost.DEFAULT_CONTENTION_MODEL.queue_threshold)


def test_modules_are_the_ports_own():
    for mod in (autotune, costmodel, ctrlplane, planner):
        assert mod.__name__.startswith("repro_torch.")
