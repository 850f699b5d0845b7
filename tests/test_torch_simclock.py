"""The port's discrete-event simulator (``repro_torch.core.simclock``) on the
CPU: the 12 tests of ``tests/test_simclock.py`` over the port's modules, and
the port against the reference for the same seed and schedule.  Tolerance:
none.  ``trace_bytes()``, the reports and ``synthetic_costs`` are equal,
byte for byte and float for float (the same arithmetic in the same order on
the same seeded numpy draws)."""

import dataclasses
import time

import numpy as np
import pytest

from repro.configs.registry import get_recsys as j_get_recsys
from repro.core import simclock as J
from repro.core.costmodel import ContentionAwareCostModel as JContentionAwareCostModel
from repro.core.spec import TransformSpec as JSpec
from repro.data.synth import SyntheticRecSysSource as JSource
from repro_torch.configs.registry import get_recsys
from repro_torch.core import simclock as T
from repro_torch.core.costmodel import ContentionAwareCostModel
from repro_torch.core.simclock import (
    SimEngine,
    SimHarness,
    SimJob,
    VirtualClock,
    synthetic_costs,
    zipf_sessions,
)
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import DeviceFleet, IoFaultInjector, PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource


@pytest.fixture
def sim_harness():
    """Factory for the port's seeded virtual-time harnesses."""

    def make(seed: int = 0, **service_kwargs):
        return SimHarness(seed=seed, **service_kwargs)

    return make


# -- the event core ------------------------------------------------------------


def test_virtual_clock_never_rewinds():
    clk = VirtualClock()
    clk.advance_to(2.5)
    assert clk.now() == 2.5
    with pytest.raises(ValueError, match="rewind"):
        clk.advance_to(1.0)


def test_engine_orders_by_time_then_schedule_order():
    eng = SimEngine()
    fired = []
    eng.at(2.0, lambda: fired.append("late"))
    eng.at(1.0, lambda: fired.append("a"))
    eng.at(1.0, lambda: fired.append("b"))
    eng.at(1.0, lambda: fired.append("c"))
    eng.at(0.5, lambda: fired.append("early"))
    n = eng.run()
    assert fired == ["early", "a", "b", "c", "late"]
    assert n == 5 and eng.now == 2.0
    with pytest.raises(ValueError, match="past"):
        eng.at(1.0, lambda: None)


def test_engine_events_may_schedule_more_events():
    eng = SimEngine()
    fired = []

    def tick(i):
        fired.append((eng.now, i))
        if i < 3:
            eng.after(1.0, lambda: tick(i + 1))

    eng.at(0.0, lambda: tick(0))
    eng.run()
    assert fired == [(0.0, 0), (1.0, 1), (2.0, 2), (3.0, 3)]


# -- virtual-time device occupancy ---------------------------------------------


def test_isp_device_reserve_serializes_in_time():
    fleet = DeviceFleet.from_cost_model(1, ContentionAwareCostModel())
    dev = fleet[0]
    s0, e0 = dev.reserve(0.0, 1.0, nbytes=100, ops=5.0)
    s1, e1 = dev.reserve(0.0, 1.0, nbytes=100, ops=5.0)
    assert (s0, e0) == (0.0, 1.0)
    assert (s1, e1) == (1.0, 2.0)  # queued behind the first
    s2, e2 = dev.reserve(5.0, 0.5)
    assert (s2, e2) == (5.0, 5.5)  # idle gap: starts at now, not free_at
    assert dev.busy_s == pytest.approx(2.5)
    assert dev.bytes_streamed == 200
    assert dev.compute_ops == pytest.approx(10.0)


def test_fleet_reserve_host_parallel_slots():
    fleet = DeviceFleet.from_cost_model(2, ContentionAwareCostModel())
    a = fleet.reserve_host(0.0, 1.0, parallelism=2)
    b = fleet.reserve_host(0.0, 1.0, parallelism=2)
    c = fleet.reserve_host(0.0, 1.0, parallelism=2)
    assert a == (0.0, 1.0) and b == (0.0, 1.0)  # two slots run concurrently
    assert c == (1.0, 2.0)  # third waits for the earliest-free slot
    assert fleet.host_busy_s == pytest.approx(3.0)
    assert fleet.host_produces == 3


# -- deterministic replay ------------------------------------------------------


def _chaos_scenario(make, seed):
    h = make(seed=seed, num_workers=4, num_devices=2, straggler_timeout=0.05)
    h.workload(40, arrival_window_s=0.5)
    h.kill_at(0.02, 1)
    h.kill_at(0.30, 0)
    h.join_at(0.40)
    return h


def test_same_seed_replay_is_byte_identical(sim_harness):
    runs = []
    for _ in range(2):
        h = _chaos_scenario(sim_harness, seed=11)
        h.run()
        runs.append(h.trace_bytes())
    assert runs[0] == runs[1]
    assert len(runs[0]) > 1000  # a real trace, not an empty log

    other = _chaos_scenario(sim_harness, seed=12)
    other.run()
    assert other.trace_bytes() != runs[0]  # the seed is load-bearing


def test_kill_mid_flight_reissues_and_still_delivers(sim_harness):
    def scenario():
        h = sim_harness(seed=5, num_workers=2, num_devices=2, straggler_timeout=0.05)
        h.submit(SimJob("victim", partitions=8))
        h.kill_at(0.004, 0)  # inside the first produce (isp_s ~ 10 ms)
        return h

    h = scenario()
    rep = h.run()
    (out,) = rep.outcomes
    assert out.status in ("admitted", "degraded") and out.finish_s is not None
    assert out.partitions == 8
    events = h.service.events.since(0)
    kinds = [e.kind for e in events]
    assert "kill" in kinds and "claim_expired" in kinds
    assert "claim_reissue" in kinds  # the straggler path re-issued it
    completes = [e for e in events if e.kind == "complete"]
    assert sorted({e.data["pid"] for e in completes}) == list(range(8))

    h2 = scenario()
    h2.run()
    assert h2.trace_bytes() == h.trace_bytes()


# -- SLO semantics -------------------------------------------------------------


def test_slo_rejects_and_degrades_instead_of_starving(sim_harness):
    reports = {}
    for policy in ("slo", "fifo"):
        h = sim_harness(seed=3, policy=policy, num_workers=4, num_devices=2)
        h.workload(300, arrival_window_s=1.2)
        reports[policy] = h.run()

    slo, fifo = reports["slo"], reports["fifo"]
    assert slo.starved_count == 0
    shed = [o for o in slo.outcomes if o.status in ("rejected", "degraded")]
    assert shed, "an overloaded SLO schedule must visibly shed load"
    assert all(o.slo_met is None for o in slo.outcomes if o.status == "rejected")
    assert fifo.starved_count > 0
    assert all(row["rejected"] == 0 for row in fifo.by_class().values())  # FIFO admits all


def test_rc_preempts_exploratory(sim_harness):
    h = sim_harness(seed=0, policy="slo", num_workers=1, num_devices=1)
    h.submit(SimJob("explore", partitions=6, arrival_s=0.0, demand_units=1))
    h.submit(SimJob("rc", partitions=4, arrival_s=0.005, demand_units=1, qos_class="rc"))
    rep = h.run()
    pre = h.service.events.tail(1000, kind="preempt")
    assert pre and pre[0].data["job"] == "explore"
    assert pre[0].data["by"] == "rc"
    out = {o.name: o for o in rep.outcomes}
    assert out["rc"].finish_s is not None
    assert out["explore"].finish_s is not None
    assert out["rc"].finish_s < out["explore"].finish_s


def test_zipf_workload_shape():
    eng = SimEngine(seed=7)
    jobs = zipf_sessions(500, rng=eng.rng, arrival_window_s=10.0)
    assert len(jobs) == 500
    sizes = sorted(j.partitions for j in jobs)
    assert sizes[len(sizes) // 2] <= 8 < sizes[-1] == 64
    arrivals = [j.arrival_s for j in jobs]
    assert arrivals == sorted(arrivals)
    assert all(0.0 <= a <= 10.0 for a in arrivals)
    rc = [j for j in jobs if j.qos_class == "rc"]
    assert 0 < len(rc) < len(jobs) // 2
    assert all(j.deadline_s and j.deadline_s > 0 for j in jobs)


def test_thousand_sessions_in_wall_clock_seconds(sim_harness):
    h = sim_harness(seed=3, policy="slo", num_workers=8, num_devices=4)
    h.workload(1000, arrival_window_s=4.0)
    t0 = time.perf_counter()
    rep = h.run()
    wall = time.perf_counter() - t0
    assert wall < 30.0, f"virtual-time run took {wall:.1f}s of real time"
    assert len(rep.outcomes) == 1000
    for o in rep.outcomes:
        assert (o.status == "rejected") == (o.finish_s is None)
    assert rep.makespan_s > 0 and rep.events_processed > 1000


def test_synthetic_costs_prefer_isp():
    costs = synthetic_costs(ContentionAwareCostModel())
    assert 0 < costs.isp_s < costs.host_s  # the byte-bound regime


# -- the port against the reference ---------------------------------------------


def _ctrl_chaos(mod, seed: int):
    """tests/test_ctrlplane.py's seeded chaos schedule under the sim clock."""
    h = mod.SimHarness(seed=seed, num_workers=3, num_devices=2, straggler_timeout=0.05)
    h.workload(24, arrival_window_s=0.4)
    sched = np.random.default_rng(seed)
    for _ in range(2):
        h.kill_at(float(sched.uniform(0.01, 0.25)), int(sched.integers(0, 3)))
    h.join_at(float(sched.uniform(0.25, 0.4)))
    return h


@pytest.mark.parametrize("seed", [1, 2])
def test_chaos_trace_bytes_equal_the_reference(seed):
    ours, theirs = _ctrl_chaos(T, seed), _ctrl_chaos(J, seed)
    rep, jrep = ours.run(), theirs.run()
    assert ours.trace_bytes() == theirs.trace_bytes()
    assert len(ours.trace_bytes()) > 1000
    assert rep.to_dict() == jrep.to_dict()


@pytest.mark.parametrize("policy", ["slo", "fifo"])
def test_workload_report_and_trace_equal_the_reference(policy):
    runs = []
    for mod in (T, J):
        h = _chaos_scenario(lambda **kw: mod.SimHarness(policy=policy, **kw), seed=11)
        rep = h.run()
        runs.append((h.trace_bytes(), rep.to_dict(),
                     [o.to_dict() for o in rep.outcomes]))
    assert runs[0] == runs[1]


def test_synthetic_costs_equal_the_reference():
    assert dataclasses.asdict(synthetic_costs(ContentionAwareCostModel())) == \
        dataclasses.asdict(J.synthetic_costs(JContentionAwareCostModel()))
    cfg, jcfg = get_recsys("rm2", reduced=True), j_get_recsys("rm2", reduced=True)
    spec = TransformSpec.from_source(SyntheticRecSysSource(cfg.data, rows=256))
    jspec = JSpec.from_source(JSource(jcfg.data, rows=256))
    for rows in (None, 512):
        ours = synthetic_costs(ContentionAwareCostModel(), spec=spec, rows=rows)
        theirs = J.synthetic_costs(JContentionAwareCostModel(), spec=jspec, rows=rows)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_zipf_sessions_equal_the_reference():
    ours = zipf_sessions(200, rng=SimEngine(seed=4).rng)
    theirs = J.zipf_sessions(200, rng=J.SimEngine(seed=4).rng)
    assert [dataclasses.asdict(j) for j in ours] == [dataclasses.asdict(j) for j in theirs]


def test_virtual_clock_sleeps_a_slow_read(rm1_src):
    """tests/test_iofaults.py's drop-in sleep: a slow read advances the
    virtual clock and blocks no real thread."""
    clock = VirtualClock()
    inj = IoFaultInjector(seed=1, slow=1.0, slow_s=3.0, sleep=clock.sleep)
    store = PartitionedStore(8, num_devices=4, source=rm1_src, fault_injector=inj)
    t0 = time.perf_counter()
    store.read(0)
    assert clock.now() == 3.0 and time.perf_counter() - t0 < 1.0


@pytest.fixture
def rm1_src():
    return SyntheticRecSysSource(get_recsys("rm1", reduced=True).data, rows=256)
