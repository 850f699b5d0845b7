"""The port's service under its control plane, storage faults and caches.

Mirrors on the CPU (``device="cpu"``) the service tests of
``tests/test_ctrlplane.py`` (kill/join, checkpoint/resume, autoscaling,
events), ``tests/test_iofaults.py`` (retry, failover and quarantine under
seeded I/O faults), ``tests/test_featcache.py`` (cross-tenant hits,
in-flight sharing, pre-warm, warm start, rebalance on hit rate),
``tests/test_devices.py`` (device-aware routing) and the block tier of
``tests/test_dedup.py``, at the reduced rm1 geometry of 256 rows.  The
invariant everywhere: whatever the chaos, a session delivers the port's
serial ``produce_batch`` batches bitwise, every key; the serial batches are
held against the reference's (integers and labels bitwise, ``dense`` to
rtol=atol=1e-6).  Where a reference test asserts a count, the mirror asserts
the same count.  The seeded chaos matrix runs its threaded half and its
virtual-time twin (the port's ``core.simclock``).
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.configs.registry import get_recsys as j_get_recsys
from repro.core.ctrlplane import SessionCheckpoint as JSessionCheckpoint
from repro.core.presto import PreStoEngine
from repro.core.spec import TransformSpec as JSpec
from repro.data.storage import PartitionedStore as JStore
from repro.data.synth import SyntheticRecSysSource as JSource
from repro_torch.configs.registry import get_recsys
from repro_torch.core.costmodel import ContentionAwareCostModel
from repro_torch.core.ctrlplane import (
    Autoscaler,
    AutoscalePolicy,
    SessionCheckpoint,
    SessionError,
)
from repro_torch.core.featcache import FeatureCache, default_spill_store
from repro_torch.core.planner import DeviceTopology
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.service import JobSpec, PreprocessingService
from repro_torch.core.simclock import SimHarness
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import (
    CacheSpillStore,
    DeviceFleet,
    IoFaultInjector,
    PartitionedStore,
    TransientReadError,
    zipf_owner_map,
)
from repro_torch.data.synth import RM_CONFIGS, SyntheticRecSysSource
from torch_service_util import assert_bitwise, bounded, collect, join_all

ROWS = 256
N_PARTS = 10
DENSE_TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=True)

# the produce-path modes the bitwise invariants must hold across
# (test_ctrlplane.py's, then test_iofaults.py's)
MODES = {
    "pipeline": dict(megabatch=2),
    "autotune": dict(autotune=True, lookahead=2),
    "cache": dict(megabatch=2),
}
IO_MODES = {
    "pipeline": dict(megabatch=2, lookahead=2),
    "autotune": dict(autotune=True),
    "cache": dict(megabatch=2),
}


def _setup(data_cfg):
    src = SyntheticRecSysSource(data_cfg, rows=ROWS)
    spec = TransformSpec.from_source(src)
    engine = TorchPreStoEngine(spec, device="cpu")
    store = PartitionedStore(N_PARTS, num_devices=4, source=src)
    # the no-failure ground truth every chaos run must match bitwise
    ref = {pid: engine.produce_batch(store, pid) for pid in range(N_PARTS)}
    return {"src": src, "spec": spec, "engine": engine, "ref": ref, "cfg": data_cfg}


@pytest.fixture(scope="module")
def rm1():
    return _setup(get_recsys("rm1", reduced=True).data)


@pytest.fixture(scope="module")
def dedup2(rm1):
    return _setup(dataclasses.replace(rm1["cfg"], dup_factor=2, dup_pool=8))


@pytest.mark.parametrize("kind", ["classic", "dedup2"])
def test_serial_ground_truth_matches_reference(rm1, dedup2, kind):
    """The ground truth of this file is the reference's batches: integers
    and labels bitwise, dense to rtol=atol=1e-6."""
    setup = rm1 if kind == "classic" else dedup2
    jcfg = j_get_recsys("rm1", reduced=True).data
    if kind == "dedup2":
        jcfg = dataclasses.replace(jcfg, dup_factor=2, dup_pool=8)
    jsrc = JSource(jcfg, rows=ROWS)
    jengine = PreStoEngine(JSpec.from_source(jsrc))
    jstore = JStore(N_PARTS, num_devices=4, source=jsrc)
    for pid in (0, N_PARTS - 1):
        want = jengine.produce_batch(jstore, pid)
        got = setup["ref"][pid]
        assert sorted(got) == sorted(want)
        for key in want:
            if key == "dense":
                np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **DENSE_TOL)
            else:
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# -- control plane: kill / join (test_ctrlplane.py) ----------------------------


class _GatedStore(PartitionedStore):
    """Holds the first read of ``gate_pid`` until released, recording which
    pool thread is inside it (a worker caught mid-flight)."""

    def __init__(self, *a, gate_pid: int = 0, **kw):
        super().__init__(*a, **kw)
        self.gate_pid = gate_pid
        self.caught = threading.Event()
        self.release = threading.Event()
        self.holder = None
        self._gate_lock = threading.Lock()

    def read(self, partition_id: int):
        hold = False
        with self._gate_lock:
            if partition_id == self.gate_pid and not self.caught.is_set():
                self.holder = threading.current_thread().name
                self.caught.set()
                hold = True
        if hold:
            assert self.release.wait(timeout=30)
        return super().read(partition_id)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_kill_worker_mid_flight_is_bitwise_identical(rm1, mode):
    store = _GatedStore(N_PARTS, num_devices=4, source=rm1["src"])
    cache = FeatureCache(256 << 20, device="cpu") if mode == "cache" else None
    svc = PreprocessingService(num_workers=3, cache=cache)
    try:
        sess = svc.submit(JobSpec(
            name=f"chaos-{mode}", partitions=range(N_PARTS),
            engine=rm1["engine"], store=store, units=3,
            straggler_timeout=60.0,  # re-issue must come from the kill, not time
            use_cache=(mode == "cache"), **MODES[mode],
        ))
        assert store.caught.wait(timeout=30)  # a worker is mid-read of pid 0
        assert store.holder.startswith("presto-pool-")
        wid = int(store.holder.rsplit("-", 1)[1])
        assert svc.kill_worker(wid) is True
        assert svc.num_workers == 2  # capacity re-planned immediately
        store.release.set()  # the dead worker wakes only to abandon its work
        got = collect(sess)
    finally:
        store.release.set()
        svc.close()
    assert_bitwise(got, rm1["ref"])
    st = sess.stats()
    assert st.done and not st.cancelled
    assert st.reissues >= 1  # the dead worker's claims went back through
    counts = svc.events.counts()
    assert counts.get("worker_leave") == 1
    assert counts.get("claim_reissue", 0) >= 1
    assert svc.stats()["events"]["counts"] == counts


def test_kill_below_admission_floor_degrades_not_evicts():
    gate = threading.Event()

    def produce(pid):
        gate.wait(timeout=10)
        return {"labels": np.full((4,), pid)}

    svc = PreprocessingService(num_workers=2)
    try:
        s1 = svc.submit(JobSpec(name="a", partitions=range(6),
                                produce_fn=produce, use_cache=False))
        s2 = svc.submit(JobSpec(name="b", partitions=range(6),
                                produce_fn=produce, use_cache=False))
        wid = next(iter(svc._workers))
        assert svc.kill_worker(wid)
        assert svc.num_workers == 1
        gate.set()
        got1, got2 = set(collect(s1)), set(collect(s2))
    finally:
        gate.set()
        svc.close()
    assert got1 == got2 == set(range(6))
    assert s1.stats().done and s2.stats().done


def test_kill_and_join_replan_device_topology():
    svc = PreprocessingService(num_workers=3, devices=3)
    try:
        assert svc._topology.units_per_device == {0: 1, 1: 1, 2: 1}
        dev_of = {w.wid: w.device for w in svc._workers.values()}
        victim = next(w for w, d in dev_of.items() if d == 2)
        assert svc.kill_worker(victim)
        assert svc._topology.units_per_device == {0: 1, 1: 1, 2: 0}
        assert svc._manned == {0, 1}  # device 2 lost its unit: host fallback
        wid = svc.add_worker()  # least-manned binding: straight back to dev 2
        assert svc._workers[wid].device == 2
        assert svc._topology.units_per_device == {0: 1, 1: 1, 2: 1}
        sess = svc.submit(JobSpec(name="topo", partitions=range(6),
                                  produce_fn=lambda p: p, use_cache=False))
        assert sorted(collect(sess)) == list(range(6))
    finally:
        svc.close()
    counts = svc.events.counts()
    assert counts.get("worker_leave") == 1 and counts.get("worker_join") == 1
    leave = svc.events.tail(50, kind="worker_leave")[0]
    assert leave.data["reason"] == "killed" and leave.data["device"] == 2


def test_add_worker_mid_session_speeds_completion():
    svc = PreprocessingService(num_workers=1)
    try:
        started = threading.Event()

        def produce(pid):
            started.set()
            time.sleep(0.005)
            return {"labels": np.full((2,), pid)}

        sess = svc.submit(JobSpec(name="grow", partitions=range(16),
                                  produce_fn=produce, use_cache=False))
        assert started.wait(timeout=10)
        for _ in range(3):
            svc.add_worker()
        assert svc.num_workers == 4
        got = set(collect(sess))
    finally:
        svc.close()
    assert got == set(range(16)) and sess.stats().done
    assert svc.events.counts().get("worker_join") == 3


def _sim_chaos_trace(seed: int) -> bytes:
    """One seeded chaos schedule under the port's sim clock -> its trace
    bytes (the reference's ``_sim_chaos_trace``)."""
    h = SimHarness(seed=seed, num_workers=3, num_devices=2, straggler_timeout=0.05)
    h.workload(24, arrival_window_s=0.4)
    sched = np.random.default_rng(seed)
    for _ in range(2):
        h.kill_at(float(sched.uniform(0.01, 0.25)), int(sched.integers(0, 3)))
    h.join_at(float(sched.uniform(0.25, 0.4)))
    h.run()
    return h.trace_bytes()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed", [1, 2])
def test_seeded_chaos_matrix_bitwise(rm1, mode, seed):
    """The reference's seeded chaos matrix: a kill (and maybe a rejoin) at a
    seeded point in delivery order, bitwise; and its virtual-time twin, the
    same seed replaying a byte-identical trace."""
    rng = np.random.default_rng(seed)
    kill_after, kill_slot = int(rng.integers(1, 4)), int(rng.integers(0, 3))
    rejoin = bool(rng.integers(0, 2))
    cache = FeatureCache(256 << 20, device="cpu") if mode == "cache" else None
    svc = PreprocessingService(num_workers=3, cache=cache)
    got = {}
    try:
        sess = svc.submit(JobSpec(
            name=f"chaos-{mode}-{seed}", partitions=range(N_PARTS),
            engine=rm1["engine"],
            store=PartitionedStore(N_PARTS, num_devices=4, source=rm1["src"]),
            units=3, straggler_timeout=60.0,
            use_cache=(mode == "cache"), **MODES[mode],
        ))
        it = iter(sess)
        for _ in range(kill_after):  # seeded kill point in delivery order
            pid, mb = bounded(next, it)
            got[pid] = mb
        wid = sorted(svc._workers)[kill_slot % len(svc._workers)]
        assert svc.kill_worker(wid) is True
        if rejoin:
            svc.add_worker()
        got.update(bounded(lambda: dict(it)))
    finally:
        svc.close()
    assert_bitwise(got, rm1["ref"])
    assert sess.stats().done
    assert svc.events.counts().get("worker_leave") == 1

    # the virtual-time twin: the SAME seed replays byte-identically
    assert _sim_chaos_trace(seed) == _sim_chaos_trace(seed)


def test_sim_chaos_traces_differ_across_seeds():
    assert _sim_chaos_trace(1) != _sim_chaos_trace(2)


# -- checkpoint / restart / resume ---------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_service_restart_resumes_bitwise_from_checkpoint(rm1, mode, tmp_path):
    ckpt = tmp_path / f"frontier-{mode}.json"
    cache = FeatureCache(256 << 20, device="cpu") if mode == "cache" else None
    job = JobSpec(
        name=f"resume-{mode}", partitions=range(N_PARTS), engine=rm1["engine"],
        store=PartitionedStore(N_PARTS, num_devices=4, source=rm1["src"]),
        units=2, use_cache=(mode == "cache"),
        checkpoint_path=str(ckpt), checkpoint_every=2, **MODES[mode],
    )

    # incarnation 1: deliver 4 batches, then the whole service dies
    svc1 = PreprocessingService(num_workers=2, cache=cache)
    got = {}
    it = iter(svc1.submit(job))
    for _ in range(4):
        pid, mb = bounded(next, it)
        got[pid] = mb
    assert svc1.events.counts().get("checkpoint", 0) >= 1
    svc1.close()

    # incarnation 2: resume from the on-disk frontier (4 delivered)
    ck = SessionCheckpoint.load(str(ckpt))
    assert ck.job == job.name and len(ck.delivered) == 4
    assert ck.remaining() == [p for p in range(N_PARTS) if p not in got]
    assert ck.to_dict() == SessionCheckpoint.from_dict(ck.to_dict()).to_dict()
    # the port's checkpoint file is the reference's format: it loads there
    # with the same frontier
    jck = JSessionCheckpoint.load(str(ckpt))
    assert jck.job == ck.job and jck.remaining() == ck.remaining()
    assert jck.to_dict() == json.loads(ckpt.read_text())
    svc2 = PreprocessingService(num_workers=2, cache=cache)
    try:
        sess2 = svc2.submit(job, resume_from=ck)
        assert sess2.total == N_PARTS - 4  # only the remainder is re-run
        rest = collect(sess2)
        assert not set(rest) & set(got)  # the delivered frontier is never re-delivered
        got.update(rest)
    finally:
        svc2.close()
    assert_bitwise(got, rm1["ref"])
    assert sess2.stats().done
    counts = svc2.events.counts()
    assert counts.get("resume") == 1 and counts.get("session_join") == 1
    if mode == "autotune":
        assert ck.tuner is not None  # the tuner state rode the checkpoint


def test_checkpoint_rejects_foreign_job():
    ck = SessionCheckpoint(job="x", partitions=[0, 1], delivered=[0])
    with pytest.raises(ValueError, match="checkpoint is for job"):
        ck.apply(JobSpec(name="y", partitions=[0, 1], produce_fn=lambda p: p))
    assert ck.fraction_done == 0.5


def test_checkpoint_at_delivery_zero_resumes_full_job(rm1):
    job = JobSpec(
        name="zero", partitions=range(N_PARTS), engine=rm1["engine"],
        store=PartitionedStore(N_PARTS, num_devices=4, source=rm1["src"]),
        units=2,
    )
    svc1 = PreprocessingService(num_workers=2)
    sess1 = svc1.submit(job)
    ck = sess1.checkpoint()  # delivery 0: nothing has reached the consumer
    svc1.close()
    assert ck.delivered == [] and ck.fraction_done == 0.0
    assert ck.remaining() == list(range(N_PARTS))

    svc2 = PreprocessingService(num_workers=2)
    try:
        sess2 = svc2.submit(job, resume_from=ck)
        assert sess2.total == N_PARTS
        got = collect(sess2)
    finally:
        svc2.close()
    assert_bitwise(got, rm1["ref"])


def test_checkpoint_after_final_partition_resumes_to_noop(rm1, tmp_path):
    ckpt = tmp_path / "final.json"
    job = JobSpec(
        name="final", partitions=range(N_PARTS), engine=rm1["engine"],
        store=PartitionedStore(N_PARTS, num_devices=4, source=rm1["src"]),
        units=2, checkpoint_path=str(ckpt), checkpoint_every=4,
    )
    svc1 = PreprocessingService(num_workers=2)
    try:
        got = collect(svc1.submit(job))
    finally:
        svc1.close()
    assert_bitwise(got, rm1["ref"])

    ck = SessionCheckpoint.load(str(ckpt))
    assert ck.fraction_done == 1.0 and ck.remaining() == []
    assert sorted(ck.delivered) == list(range(N_PARTS))
    assert JSessionCheckpoint.load(str(ckpt)).remaining() == []

    svc2 = PreprocessingService(num_workers=2)
    try:
        sess2 = svc2.submit(job, resume_from=ck)
        assert sess2.total == 0
        assert collect(sess2) == {}  # nothing re-delivered, the stream just ends
        assert sess2.stats().done and not sess2.stats().cancelled
    finally:
        svc2.close()


def test_resume_with_stale_cache_root_still_bitwise(rm1):
    job = JobSpec(
        name="stale-cache", partitions=range(N_PARTS), engine=rm1["engine"],
        store=PartitionedStore(N_PARTS, num_devices=4, source=rm1["src"]),
        units=2, use_cache=True, megabatch=2,
    )
    svc1 = PreprocessingService(num_workers=2, cache=FeatureCache(256 << 20, device="cpu"))
    got = {}
    it1 = iter(svc1.submit(job))
    for _ in range(N_PARTS // 2):
        pid, mb = bounded(next, it1)
        got[pid] = mb
    ck = SessionCheckpoint(job=job.name, partitions=list(range(N_PARTS)),
                           delivered=sorted(got))
    svc1.close()

    # brand-new cache: the old root's contents are unreachable (stale)
    svc2 = PreprocessingService(num_workers=2, cache=FeatureCache(256 << 20, device="cpu"))
    try:
        sess2 = svc2.submit(job, resume_from=ck)
        rest = collect(sess2)
        assert not set(rest) & set(got)
        got.update(rest)
    finally:
        svc2.close()
    assert_bitwise(got, rm1["ref"])
    st = sess2.stats()
    assert st.done and st.cache_hits == 0  # nothing survived the stale root


# -- autoscaling -----------------------------------------------------------------


def test_autoscaler_grows_under_backlog_and_shrinks_when_drained():
    hold = threading.Event()

    def produce(pid):
        hold.wait(timeout=30)  # deterministic backlog: nothing drains yet
        return {"labels": np.full((4,), pid)}

    svc = PreprocessingService(num_workers=2)
    scaler = Autoscaler(svc, AutoscalePolicy(
        min_workers=1, max_workers=4, backlog_per_worker=2.0))
    try:
        s1 = svc.submit(JobSpec(name="t1", partitions=range(12),
                                produce_fn=produce, units=3, use_cache=False))
        s2 = svc.submit(JobSpec(name="t2", partitions=range(12),
                                produce_fn=produce, units=3, use_cache=False))
        snap = svc.load_snapshot()
        assert snap["backlog"] == 24 and snap["workers"] == 2
        assert scaler.desired(snap) == 4  # backlog-capped want, bound-clamped
        for want in (3, 4):  # max_step=1: one worker per evaluation
            assert scaler.step() == 1 and svc.num_workers == want
        assert scaler.step() == 0  # at the bound: no further growth
        hold.set()
        bounded(s1.drain)
        bounded(s2.drain)
        deadline = time.monotonic() + 10
        while svc.load_snapshot()["sessions"] and time.monotonic() < deadline:
            time.sleep(0.01)  # retire is on the worker path; give it a beat
        while scaler.step() < 0:
            pass
        assert svc.num_workers == 1  # drained: back to the floor
    finally:
        hold.set()
        scaler.stop()
        svc.close()
    counts = svc.events.counts()
    assert counts.get("scale_up") == 2 and counts.get("worker_join") == 2
    assert counts.get("scale_down") == 3 and counts.get("worker_leave") == 3
    ups = svc.events.tail(50, kind="scale_up")
    assert all(e.data["backlog"] > 0 and e.data["target"] == 4 for e in ups)


def test_remove_worker_respects_admission_floor():
    svc = PreprocessingService(num_workers=2)
    try:
        gate = threading.Event()

        def produce(pid):
            gate.wait(timeout=10)
            return pid

        s1 = svc.submit(JobSpec(name="f1", partitions=range(3),
                                produce_fn=produce, use_cache=False))
        s2 = svc.submit(JobSpec(name="f2", partitions=range(3),
                                produce_fn=produce, use_cache=False))
        assert svc.remove_worker() is None  # 2 sessions need 2 units
        gate.set()
        bounded(s1.drain)
        bounded(s2.drain)
        deadline = time.monotonic() + 10
        while svc.load_snapshot()["sessions"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.remove_worker() is not None  # drained: shrink allowed
        assert svc.num_workers == 1
        assert svc.remove_worker() is None  # never below one worker
    finally:
        svc.close()


# -- storage fault domain (test_iofaults.py) -------------------------------------


def _run_faulted(setup, tag, inj, *, cache=None, io_retries=4, **job_kw):
    fleet = DeviceFleet(4)
    store = PartitionedStore(
        N_PARTS, num_devices=4, source=setup["src"], fleet=fleet,
        fault_injector=inj,
    )
    svc = PreprocessingService(num_workers=3, devices=fleet, cache=cache)
    try:
        session = svc.submit(JobSpec(
            name=tag, partitions=range(N_PARTS), engine=setup["engine"],
            store=store, io_retries=io_retries, io_backoff_s=0.002, **job_kw,
        ))
        got = collect(session)
        return got, session.stats(), svc.events.counts()
    finally:
        svc.close()


@pytest.mark.parametrize("mode", sorted(IO_MODES))
def test_session_bitwise_identical_under_io_faults(rm1, mode):
    inj = IoFaultInjector(
        seed=13, transient=0.3, corrupt=0.2, spill=0.5, slow=0.2, slow_s=1e-4,
        offline_device=1, offline_after=N_PARTS,
    )
    cache = None
    if mode == "cache":
        # a tiny memory tier forces evictions into the (corruptible) spill
        # store; corrupt spill hits must recompute cold, never mis-serve
        spill = default_spill_store(4)
        spill.fault_injector = inj
        cache = FeatureCache(1 << 16, spill=spill, device="cpu")
    got, st, events = _run_faulted(rm1, f"chaos-{mode}", inj, cache=cache, **IO_MODES[mode])
    assert_bitwise(got, rm1["ref"])
    assert st.done and not st.cancelled and st.quarantined == 0
    assert sum(inj.summary().values()) > 0, "the drill injected nothing"
    if st.retries:
        assert events.get("retry", 0) >= 1  # every retry is observable
    if mode == "cache":
        # a second tenant over the same content re-probes the cache: corrupt
        # spill blocks must yield recomputes, still bitwise clean
        got2, st2, _ = _run_faulted(rm1, "chaos-cache-2", inj, cache=cache, **IO_MODES[mode])
        assert_bitwise(got2, rm1["ref"])
        assert st2.quarantined == 0


def test_session_chaos_matrix_records_retries_somewhere(rm1):
    total = 0
    for i, (mode, kw) in enumerate(sorted(IO_MODES.items())):
        inj = IoFaultInjector(seed=100 + i, transient=0.4, corrupt=0.2)
        got, st, _ev = _run_faulted(rm1, f"retry-{mode}", inj, **kw)
        assert_bitwise(got, rm1["ref"])
        total += st.retries
    assert total > 0


def test_quarantine_raises_structured_error_without_hanging(rm1):
    inj = IoFaultInjector(seed=7, transient=1.0)
    fleet = DeviceFleet(4)
    store = PartitionedStore(N_PARTS, num_devices=4, source=rm1["src"], fleet=fleet,
                             fault_injector=inj)
    svc = PreprocessingService(num_workers=2, devices=fleet)
    try:
        session = svc.submit(JobSpec(
            name="poison", partitions=range(N_PARTS), engine=rm1["engine"],
            store=store, io_retries=2, io_backoff_s=1e-3,
        ))
        t0 = time.perf_counter()
        with pytest.raises(SessionError) as ei:
            collect(session)
        assert time.perf_counter() - t0 < 30.0, "quarantine took implausibly long"
        err = ei.value
        assert err.job == "poison" and err.attempts == 2
        assert isinstance(err.cause, TransientReadError)
        st = session.stats()
        assert st.quarantined >= 1 and st.retries >= 2
        assert svc.events.counts().get("quarantine", 0) >= 1
        session.cancel()
    finally:
        svc.close()


def test_offline_device_fails_over_and_completes(rm1):
    inj = IoFaultInjector(seed=3, offline_device=1, offline_after=1)
    got, st, events = _run_faulted(rm1, "failover", inj, megabatch=2)
    assert_bitwise(got, rm1["ref"])
    assert st.failovers >= 1 and st.quarantined == 0
    assert events.get("device_offline", 0) == 1
    assert events.get("failover", 0) >= 1


def test_dedup_session_bitwise_identical_under_io_faults(dedup2):
    inj = IoFaultInjector(seed=21, transient=0.3, corrupt=0.2)
    got, st, _ev = _run_faulted(dedup2, "dedup-chaos", inj, megabatch=2)
    assert_bitwise(got, dedup2["ref"])
    assert st.done and st.quarantined == 0


def test_injector_events_wired_to_service_stream(rm1):
    inj = IoFaultInjector(seed=13, transient=0.5)
    assert inj.events is None
    _got, st, events = _run_faulted(rm1, "wired", inj)
    assert inj.events is not None  # Session.__init__ bound it
    if st.retries:
        assert events.get("io_fault", 0) >= 1


# -- the shared feature cache (test_featcache.py) ---------------------------------


@pytest.fixture(scope="module")
def cached12(rm1):
    """12 partitions of the rm1 source and their serial batches."""
    store = PartitionedStore(12, num_devices=4, source=rm1["src"])
    engine = rm1["engine"]
    return store, engine, {pid: engine.produce_batch(store, pid) for pid in range(12)}


def test_two_overlapping_sessions_dedup_hits(cached12):
    store, engine, ref = cached12
    cache = FeatureCache(256 << 20, device="cpu")
    with PreprocessingService(num_workers=2, cache=cache) as svc:
        a = svc.submit(JobSpec(name="a", partitions=range(0, 8), engine=engine,
                               store=store, units=2))
        out_a = collect(a)
        b = svc.submit(JobSpec(name="b", partitions=range(4, 12), engine=engine,
                               store=store, units=2))
        out_b = collect(b)
    sa, sb = a.stats(), b.stats()
    assert sa.cache_hits == 0 and sa.cache_misses == 8
    assert sb.cache_hits == 4 and sb.cache_misses == 4  # pids 4..7 shared
    assert_bitwise(out_a, {p: ref[p] for p in range(0, 8)})
    assert_bitwise(out_b, {p: ref[p] for p in range(4, 12)})
    cs = cache.stats()
    assert cs.hits + cs.follows >= 4
    assert svc.stats()["cache"].insertions >= 8


def test_concurrent_overlapping_sessions_share_inflight(rm1, cached12):
    """Tenants racing the same cold partitions: every shared pid is produced
    once; the second tenant hits or follows, never recomputes."""
    _store, engine, ref = cached12

    class SlowStore(PartitionedStore):
        def read(self, pid):
            time.sleep(0.02)
            return super().read(pid)

    cache = FeatureCache(256 << 20, device="cpu")
    outs = {"a": {}, "b": {}}
    with PreprocessingService(num_workers=4, cache=cache) as svc:
        slow = SlowStore(12, num_devices=4, source=rm1["src"])
        sessions = {
            name: svc.submit(JobSpec(name=name, partitions=range(0, 6),
                                     engine=engine, store=slow, units=2))
            for name in outs
        }
        threads = [
            threading.Thread(target=lambda n: outs[n].update(collect(sessions[n])),
                             args=(name,))
            for name in outs
        ]
        for t in threads:
            t.start()
        join_all(threads)
    cs = cache.stats()
    assert cs.misses == 6  # 12 probes over 6 distinct partitions
    assert cs.hits + cs.follows == 6
    for name in outs:
        assert_bitwise(outs[name], {p: ref[p] for p in range(6)})


def test_produce_fn_jobs_bypass_cache():
    cache = FeatureCache(1 << 20, device="cpu")
    with PreprocessingService(num_workers=2, cache=cache) as svc:
        s = svc.submit(JobSpec(name="opaque", partitions=range(4),
                               produce_fn=lambda pid: {"pid": pid}))
        assert sorted(collect(s)) == list(range(4))
    assert cache.stats().probes == 0
    assert s.stats().cache_hits == 0 and s.stats().cache_misses == 0


def test_warm_start_restarted_service_serves_bitwise_hits(cached12, tmp_path):
    store, engine, ref = cached12
    one = sum(v.numel() * v.element_size() for v in ref[0].values())
    capacity = int(1.5 * one)

    def boot():
        spill = CacheSpillStore(num_devices=2, root=str(tmp_path))
        cache = FeatureCache(capacity_bytes=capacity, spill=spill, device="cpu")
        return cache, PreprocessingService(num_workers=2, cache=cache)

    def job():
        return JobSpec(name="warm", partitions=range(6), engine=engine,
                       store=store, units=2)

    cache1, svc1 = boot()
    with svc1:
        out1 = collect(svc1.submit(job()))
    assert len(cache1.spill) >= 6  # close() flushed the memory tier

    cache2, svc2 = boot()  # the restart: boot warm-starts from the blocks
    with svc2:
        assert cache2.stats().warm_started >= 1
        sess = svc2.submit(job())
        out2 = collect(sess)
        st = sess.stats()
    assert st.cache_hits == 6 and st.cache_misses == 0
    assert st.produced == 0  # not one recompute after the restart
    assert_bitwise(out1, {p: ref[p] for p in range(6)})
    assert_bitwise(out2, {p: ref[p] for p in range(6)})


def test_service_rebalances_on_hit_rate_change(cached12):
    """A session whose claims start hitting sheds share to the cold tenant."""
    store, engine, ref = cached12
    cache = FeatureCache(256 << 20, device="cpu")
    with PreprocessingService(num_workers=2, cache=cache) as svc:
        bounded(svc.submit(JobSpec(name="warm", partitions=range(0, 6), engine=engine,
                                   store=store, units=2)).drain)

    def slow_produce(pid):
        time.sleep(0.01)
        return {"pid": pid}

    with PreprocessingService(num_workers=4, cache=cache) as svc:
        cold = svc.submit(JobSpec(name="cold", partitions=range(200),
                                  produce_fn=slow_produce, units=4))
        it = iter(cold)
        bounded(next, it)
        hot = svc.submit(JobSpec(name="hot", partitions=range(0, 6),
                                 engine=engine, store=store, units=3))
        out_hot = collect(hot)
        # hot's 100% hit rate discounts its demand to the 1-unit floor; the
        # next re-plan hands the freed units to the cold job
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if hot.stats().done and svc.plan.shares.get("cold", 0) >= 3:
                break
            bounded(next, it, None)
            time.sleep(0.005)
        st = hot.stats()
        plan = svc.plan
        cold.cancel()
    assert_bitwise(out_hot, {p: ref[p] for p in range(6)})
    assert st.cache_hits == 6 and st.cache_misses == 0  # fully cache-fed
    assert st.effective_demand_units == 1  # discounted to the floor
    assert plan.shares.get("cold", 0) >= 3


def test_service_prewarms_ahead_of_claims_bitwise(cached12):
    store, engine, ref = cached12
    cache = FeatureCache(256 << 20, device="cpu")
    with PreprocessingService(num_workers=1, cache=cache) as svc:
        bounded(svc.submit(JobSpec(name="seed", partitions=range(6, 12), engine=engine,
                                   store=store, units=1)).drain)
        session = svc.submit(JobSpec(
            name="walk", partitions=range(12), engine=engine, store=store,
            units=1, queue_depth=12, lookahead=4, megabatch=2))
        got = collect(session)
        st = session.stats()
    assert_bitwise(got, ref)
    assert st.done
    assert st.prewarm_hits > 0  # the walker reached the cached back half
    assert cache.stats().prewarm_hits >= st.prewarm_hits


def test_prewarm_off_keeps_lookahead_window(cached12):
    store, engine, ref = cached12
    cache = FeatureCache(256 << 20, device="cpu")
    with PreprocessingService(num_workers=1, cache=cache) as svc:
        session = svc.submit(JobSpec(
            name="nowarm", partitions=range(12), engine=engine, store=store,
            units=1, queue_depth=12, lookahead=4, prewarm=False))
        got = collect(session)
        st = session.stats()
    assert_bitwise(got, ref)
    assert st.prewarm_hits == 0 and cache.stats().prewarm_hits == 0
    assert st.staged_bytes_peak > 0  # the window pre-staged all the same


# -- the block tier (test_dedup.py) -------------------------------------------------


def test_service_cross_tenant_block_assembly():
    """Tenant B's batches assemble from tenant A's published blocks, bitwise
    a cold serial produce; A runs the megabatched, autotuned path."""
    cfg = dataclasses.replace(RM_CONFIGS["rm2"], rows_per_partition=128, dup_factor=4,
                              dup_pool=16)
    src = SyntheticRecSysSource(cfg, seed=3)
    engine = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    store = PartitionedStore(16, num_devices=2, source=src)
    ref = {pid: engine.produce_batch(PartitionedStore(16, 2, src), pid) for pid in range(16)}
    svc = PreprocessingService(num_workers=2, cache=FeatureCache(64 << 20, device="cpu"))
    try:
        sA = svc.submit(JobSpec(name="A", store=store, engine=engine,
                                partitions=range(8), megabatch=4, autotune=True))
        outA = collect(sA)
        sB = svc.submit(JobSpec(name="B", store=store, engine=engine,
                                partitions=range(8, 16)))
        outB = collect(sB)
        stA, stB = sA.stats(), sB.stats()
    finally:
        svc.close()
    assert stA.blocks_published > 0
    assert stB.block_hits > 0  # cross-tenant: B never produced cold
    assert stB.block_hits == stB.cache_hits  # block assemblies count as hits
    assert_bitwise({**outA, **outB}, ref)
    assert store.bytes_read < store.logical_bytes_read  # unique bytes charged


# -- device-aware routing (test_devices.py) ----------------------------------------


def _hold_until_shed(dev, timeout: float = 30.0) -> None:
    """Make `dev`'s ISP produces wait, outside every lock, until the router
    has shed one of `dev`'s claims to the host (or `timeout` s pass).

    The reference's twin relies on the hot device's queue still being above
    the threshold when the other devices run out of their own work.  There
    every worker's first launch meets one jit compile and each worker stages
    its next claim while XLA computes, so the cold workers reach the hot
    backlog while it is deep.  The port compiles nothing and computes
    synchronously on the CPU, so the race is lost now and then under load
    (host_fallbacks == 0).  Holding the hot device's own produces makes the
    hot queue the slow one deterministically; a router that never sheds
    still fails the assertions, after the timeout."""
    begin = dev.begin_claim
    deadline = [None]

    def held():
        if deadline[0] is None:
            deadline[0] = time.monotonic() + timeout
        while dev.host_fallbacks == 0 and time.monotonic() < deadline[0]:
            time.sleep(0.001)
        begin()

    dev.begin_claim = held


def _run_routed(rm1, *, owner_map, locality, partitions, devices, threshold, hold=None):
    fleet = DeviceFleet(devices)
    if hold is not None:
        _hold_until_shed(fleet[hold])
    store = PartitionedStore(partitions, num_devices=devices, source=rm1["src"],
                             fleet=fleet, owner_map=owner_map)
    model = ContentionAwareCostModel(queue_threshold=threshold)
    with PreprocessingService(num_workers=devices, devices=fleet, locality=locality,
                              cost_model=model) as svc:
        sess = svc.submit(JobSpec(name="skewed", partitions=range(partitions),
                                  engine=rm1["engine"], store=store, units=devices,
                                  queue_depth=partitions))
        out = collect(sess)
        stats = sess.stats()
    return out, stats, fleet


def test_zipf_routing_bitwise_fallback_and_inflight_bound(rm1):
    devices, partitions, threshold = 4, 16, 5
    skew_map = zipf_owner_map(partitions, devices, alpha=1.1, seed=0)
    assert max(skew_map.count(d) for d in range(devices)) > threshold
    hot = max(range(devices), key=skew_map.count)
    serial_store = PartitionedStore(partitions, num_devices=devices, source=rm1["src"])
    ref = {p: rm1["engine"].produce_batch(serial_store, p) for p in range(partitions)}
    runs = {}
    for name, owner_map, locality, hold in (("uniform", None, True, None),
                                            ("blind", skew_map, False, None),
                                            ("routed", skew_map, True, hot)):
        runs[name] = _run_routed(rm1, owner_map=owner_map, locality=locality,
                                 partitions=partitions, devices=devices, threshold=threshold,
                                 hold=hold)
    (_, st_u, _), (_, st_b, fleet_b), (_, st_r, fleet_r) = (
        runs["uniform"], runs["blind"], runs["routed"])
    assert st_u.host_fallbacks == 0 and st_b.host_fallbacks == 0
    assert st_r.host_fallbacks > 0
    assert fleet_r.host_produces == st_r.host_fallbacks
    for out, _st, _fleet in runs.values():  # routing never changes the bytes
        assert_bitwise(out, ref)
    topo = DeviceTopology.round_robin(devices, devices)
    for dev in fleet_r:
        assert dev.max_inflight <= topo.units_per_device[dev.device_id] + 1
    assert fleet_r.makespan_s(host_parallelism=devices) < fleet_b.makespan_s(
        host_parallelism=devices)
    assert sum(st_r.device_produced.values()) + st_r.host_fallbacks >= partitions


def test_host_fallback_covers_unmanned_devices(rm1):
    fleet = DeviceFleet(4)
    store = PartitionedStore(8, num_devices=4, source=rm1["src"], fleet=fleet)
    with PreprocessingService(num_workers=2, devices=fleet) as svc:
        sess = svc.submit(JobSpec(name="undermanned", partitions=range(8),
                                  engine=rm1["engine"], store=store, units=2, queue_depth=8))
        out = collect(sess)
        st = sess.stats()
    assert_bitwise(out, {p: rm1["ref"][p] for p in range(8)})
    assert st.host_fallbacks >= 4  # devices 2 and 3 are unmanned
    assert st.done and not st.cancelled


def test_locality_blind_charges_owner_devices(rm1):
    out, st, fleet = _run_routed(rm1, owner_map=[0] * 6 + [1, 2], locality=False,
                                 partitions=8, devices=4, threshold=100)
    assert_bitwise(out, {p: rm1["ref"][p] for p in range(8)})
    assert st.host_fallbacks == 0
    assert st.device_produced.get(0, 0) == 6
    assert fleet[0].busy_s > fleet[1].busy_s > 0
    assert fleet[3].busy_s == 0.0
