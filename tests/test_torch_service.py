"""The port's preprocessing service: shared pool, sessions, admission, QoS.

Mirrors ``tests/test_service.py`` on the CPU (``device="cpu"``), at the
reduced rm1 geometry of 256 rows, and adds the port's own cases: megabatch
and autotune sessions, the page-size pins behind lookahead pre-staging, the
engine's one dispatch pair, and a ``JobSpec`` with no device.

Every delivered batch is held two ways: against the port's own serial
``produce_batch`` on the same store, every key bitwise; and against the
reference's ``PreStoEngine.produce_batch`` on an equal store, integers and
``labels`` bitwise, ``dense`` to rtol=atol=1e-6 with NaN equal (``log1p``
differs by up to 1 ulp between the libraries).  Every wait is bounded.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.configs.registry import get_recsys as j_get_recsys
from repro.core.planner import plan_pool as j_plan_pool
from repro.core.presto import PreStoEngine
from repro.core.service import JobSpec as JJobSpec
from repro.core.service import PreprocessingService as JService
from repro.core.spec import TransformSpec as JSpec
from repro.data.storage import PartitionedStore as JStore
from repro.data.synth import SyntheticRecSysSource as JSource
from repro.data.synth import make_rm_source as j_make_rm_source
from repro_torch.configs.registry import get_recsys
from repro_torch.core.autotune import DEFAULT_AUTOTUNE_KMAX
from repro_torch.core.featcache import FeatureCache
from repro_torch.core.planner import AdmissionError, plan_pool
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.service import JobSpec, PreprocessingService
from repro_torch.core.spec import TransformSpec
from repro_torch.data.loader import SessionQueue
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource, make_rm_source
from torch_service_util import assert_bitwise, bounded, collect, join_all

ROWS = 256
N_PARTS = 12
DENSE_TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.fixture(scope="module")
def rm1():
    rcfg = get_recsys("rm1", reduced=True)
    src = SyntheticRecSysSource(rcfg.data, rows=ROWS)
    spec = TransformSpec.from_source(src)
    store = PartitionedStore(N_PARTS, num_devices=4, source=src)
    engine = TorchPreStoEngine(spec, device="cpu")
    serial = {pid: engine.produce_batch(store, pid) for pid in range(N_PARTS)}
    return spec, store, engine, serial


@pytest.fixture(scope="module")
def reference():
    """The JAX package's batches for the same partitions."""
    jsrc = JSource(j_get_recsys("rm1", reduced=True).data, rows=ROWS)
    jengine = PreStoEngine(JSpec.from_source(jsrc))
    jstore = JStore(N_PARTS, num_devices=4, source=jsrc)
    return jengine, jstore, {p: jengine.produce_batch(jstore, p) for p in range(N_PARTS)}


def collect_into(session, out: dict):
    out.update(collect(session))


def assert_matches_reference(got: dict, ref: dict) -> None:
    for pid, batch in got.items():
        want = ref[pid]
        assert sorted(batch) == sorted(want)
        for key in want:
            g, w = batch[key].numpy(), np.asarray(want[key])
            if key == "dense":
                np.testing.assert_allclose(g, w, **DENSE_TOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"pid={pid} key={key}")


# -- planner ------------------------------------------------------------------


def test_plan_pool_floor_and_proportional_shares():
    plan = plan_pool(8, {"a": 6, "b": 2, "c": 1})
    assert plan.shares == {"a": 5, "b": 2, "c": 1}  # floor 1 + largest remainder
    assert sum(plan.shares.values()) <= plan.capacity
    assert plan.oversubscribed
    assert plan.shares == j_plan_pool(8, {"a": 6, "b": 2, "c": 1}).shares
    # surplus beyond aggregate demand stays idle (capped at demand)
    plan = plan_pool(16, {"a": 2, "b": 1})
    assert plan.shares == {"a": 2, "b": 1}
    assert not plan.oversubscribed


def test_plan_pool_admission_floor():
    with pytest.raises(AdmissionError):
        plan_pool(2, {"a": 1, "b": 1, "c": 1})


# -- session queue (the per-session half of the pool contract) ----------------


def test_session_queue_backpressure_allows_reissue_only():
    q = SessionQueue(range(4), depth=2, straggler_timeout=0.0)
    a = q.claim()
    b = q.claim()
    assert a[0] == 0 and b[0] == 1
    # two undelivered claims = at depth: fresh claims refused...
    time.sleep(0.01)
    c = q.claim()
    assert c is not None and c[0] in (0, 1)  # ...but a straggler backup is not
    assert c[1] is (a[1] if c[0] == 0 else b[1])  # same future, no new delivery
    assert q.work.reissues == 1
    # duplicate completion is dropped, winner resolves the future
    assert q.complete(c[0], "first") is True
    assert q.complete(c[0], "second") is False
    assert q.out.get_nowait().result(timeout=1)[1] == "first"
    # still at depth, so only the overdue straggler (pid 1) is claimable again
    d = q.claim()
    assert d[0] == 1 and q.work.reissues == 2
    q.mark_delivered()
    assert q.claim()[0] == 2  # pacing signal reopens fresh claims
    assert c[0] not in q._futures  # completed futures leave the claim map


def test_raw_futures_stream_accounts_delivery_and_done():
    with PreprocessingService(num_workers=2) as svc:
        s = svc.submit(JobSpec(name="raw", partitions=range(6),
                               produce_fn=lambda pid: pid))
        got = bounded(lambda: [fut.result(timeout=10) for fut in s.futures()])
    assert sorted(pid for pid, _ in got) == list(range(6))
    st = s.stats()
    assert st.done and st.delivered == 6 and not st.cancelled


def test_duplicate_partition_ids_deduped_not_hung():
    with PreprocessingService(num_workers=2) as svc:
        s = svc.submit(JobSpec(name="dups", partitions=[0, 0, 1, 2, 1],
                               produce_fn=lambda pid: pid))
        assert s.total == 3
        assert sorted(collect(s)) == [0, 1, 2]
        assert s.stats().done


def test_session_reiteration_resumes_where_it_stopped():
    with PreprocessingService(num_workers=2) as svc:
        s = svc.submit(JobSpec(name="resume", partitions=range(10),
                               produce_fn=lambda pid: pid))
        it = iter(s)
        first = [bounded(next, it) for _ in range(3)]
        rest = bounded(s.drain)  # a fresh iterator delivers the remaining 7
        assert len(first) == 3 and rest == 7
        assert s.stats().done and s.stats().delivered == 10


# -- the acceptance criterion -------------------------------------------------


@pytest.mark.parametrize("cached", [False, True], ids=["no-cache", "cache"])
def test_two_sessions_bitwise_identical_to_single_tenant(rm1, reference, cached):
    """Overlapping tenants each see exactly their solo batches: bitwise the
    port's serial produce, and the reference's batches to the tolerance."""
    spec, store, engine, serial = rm1
    if cached:
        parts = {"tenant-a": range(0, 8), "tenant-b": range(4, 12)}  # overlap
    else:
        parts = {"tenant-a": range(0, 6), "tenant-b": range(6, 12)}

    def job(name):
        return JobSpec(name=name, partitions=parts[name], engine=engine,
                       store=store, units=2)

    solo = {}
    for name in parts:
        with PreprocessingService(num_workers=2) as svc:
            solo[name] = collect(svc.submit(job(name)))

    cache = FeatureCache(256 << 20, device="cpu") if cached else None
    shared = {name: {} for name in parts}
    with PreprocessingService(num_workers=2, cache=cache) as svc:
        sessions = {name: svc.submit(job(name)) for name in parts}
        threads = [
            threading.Thread(target=collect_into, args=(sessions[n], shared[n]))
            for n in parts
        ]
        for t in threads:
            t.start()
        join_all(threads)
        stats = {name: sessions[name].stats() for name in parts}

    for name in parts:
        assert sorted(shared[name]) == list(parts[name])  # all pids, no dupes
        assert stats[name].done and not stats[name].cancelled
        assert_bitwise(shared[name], solo[name], f"{name} under sharing")
        assert_bitwise(shared[name], {p: serial[p] for p in parts[name]}, name)
        assert_matches_reference(shared[name], reference[2])
    if cached:
        cs = cache.stats()
        assert cs.hits + cs.follows >= 4  # the overlap deduplicated


def test_two_cached_sessions_at_rm1_width_match_reference():
    """rm1 at its own widths (``make_rm_source``, 256 rows): two tenants of
    one content through the shared cache deliver the reference's batches,
    and the port's serial batches bitwise."""
    src, jsrc = make_rm_source("rm1", rows=ROWS), j_make_rm_source("rm1", rows=ROWS)
    store, jstore = PartitionedStore(4, 4, source=src), JStore(4, 4, source=jsrc)
    engine = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    jengine = PreStoEngine(JSpec.from_source(jsrc))
    serial = {pid: engine.produce_batch(store, pid) for pid in range(4)}
    with PreprocessingService(num_workers=2, cache=FeatureCache(256 << 20, device="cpu")) as svc:
        a, b = (svc.submit(JobSpec(name=n, partitions=range(4), engine=engine, store=store,
                                   megabatch=2)) for n in ("a", "b"))
        got = {"a": {}, "b": {}}
        threads = [threading.Thread(target=collect_into, args=(s, got[s.name])) for s in (a, b)]
        for t in threads:
            t.start()
        join_all(threads)
        hits = a.stats().cache_hits + b.stats().cache_hits
    assert hits == 4  # 8 probes of 4 contents: each produced once
    for name in got:
        assert_bitwise(got[name], serial, name)
        assert_matches_reference(got[name], {p: jengine.produce_batch(jstore, p)
                                             for p in range(4)})


# -- straggler re-issue through the Session API --------------------------------


def test_straggler_reissue_and_duplicate_drop_two_sessions():
    def make_produce(slow_pid, delay):
        def produce(pid):
            if pid == slow_pid:
                time.sleep(delay)
            return {"pid": pid}
        return produce

    with PreprocessingService(num_workers=3) as svc:
        slow = svc.submit(JobSpec(
            name="slow", partitions=range(6),
            produce_fn=make_produce(2, 0.5), straggler_timeout=0.05, units=2))
        fast = svc.submit(JobSpec(
            name="fast", partitions=range(6),
            produce_fn=make_produce(-1, 0.0), units=1))
        out_fast: dict = {}
        t = threading.Thread(target=collect_into, args=(fast, out_fast))
        t.start()
        out_slow = collect(slow)
        join_all([t])
        # the slow copy's completion may still be in flight: give the pool a
        # beat to record the drop
        deadline = time.monotonic() + 2.0
        while slow.stats().duplicates_dropped == 0 and time.monotonic() < deadline:
            time.sleep(0.01)

    assert sorted(out_slow) == list(range(6))  # every batch once, no dupes
    assert sorted(out_fast) == list(range(6))
    assert slow.stats().reissues > 0
    assert slow.stats().duplicates_dropped >= 1
    assert fast.stats().reissues == 0


# -- admission, rebalance, cancel ---------------------------------------------


def test_admission_and_rebalance_on_join_and_leave():
    def produce(pid):
        time.sleep(0.002)
        return pid

    with PreprocessingService(num_workers=2) as svc:
        s1 = svc.submit(JobSpec(name="j1", partitions=range(50),
                                produce_fn=produce, units=2))
        assert s1.share == 2  # alone: full pool
        s2 = svc.submit(JobSpec(name="j2", partitions=range(50),
                                produce_fn=produce, units=2))
        assert s1.share == 1 and s2.share == 1  # join rebalances
        with pytest.raises(AdmissionError):
            svc.submit(JobSpec(name="j3", partitions=range(4),
                               produce_fn=produce))
        with pytest.raises(ValueError, match="already active"):
            svc.submit(JobSpec(name="j2", partitions=range(4),
                               produce_fn=produce))
        s1.cancel()
        assert s2.share == 2  # leave rebalances
        s3 = svc.submit(JobSpec(name="j3", partitions=range(4),
                                produce_fn=produce))  # admission slot freed
        assert sorted(collect(s3)) == list(range(4))
        assert s1.stats().cancelled
        s2.cancel()


def test_cancel_stops_stream_and_pool_serves_others():
    def produce(pid):
        time.sleep(0.005)
        return pid

    with PreprocessingService(num_workers=2) as svc:
        s1 = svc.submit(JobSpec(name="big", partitions=range(40),
                                produce_fn=produce))
        s2 = svc.submit(JobSpec(name="small", partitions=range(8),
                                produce_fn=produce))
        it = iter(s1)
        got = [bounded(next, it) for _ in range(3)]
        s1.cancel()
        assert bounded(s1.drain) == 0  # a cancelled stream yields nothing further
        assert len(got) == 3 and s1.stats().delivered == 3
        assert sorted(collect(s2)) == list(range(8))
        assert s2.stats().done


def test_worker_error_propagates_to_consumer_only():
    def explode(pid):
        if pid == 1:
            raise RuntimeError("storage device on fire")
        return pid

    with PreprocessingService(num_workers=2) as svc:
        bad = svc.submit(JobSpec(name="bad", partitions=range(3),
                                 produce_fn=explode))
        good = svc.submit(JobSpec(name="good", partitions=range(5),
                                  produce_fn=lambda pid: pid))
        with pytest.raises(RuntimeError, match="on fire"):
            collect(bad)
        bad.cancel()
        assert sorted(collect(good)) == list(range(5))


def test_closed_service_raises_for_blocked_consumer():
    svc = PreprocessingService(num_workers=1)
    session = svc.submit(JobSpec(name="orphan", partitions=range(4),
                                 produce_fn=lambda pid: time.sleep(0.05) or pid))
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        collect(session)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(JobSpec(name="late", partitions=range(1),
                           produce_fn=lambda pid: pid))


def test_qos_demand_reestimated_from_measured_P():
    rows = 64

    def produce(pid):
        time.sleep(0.01)  # P ~= 6400 samples/s per worker
        return {"labels": np.zeros((rows,), np.float32)}

    with PreprocessingService(num_workers=4) as svc:
        s = svc.submit(JobSpec(name="qos", partitions=range(30),
                               produce_fn=produce,
                               target_samples_per_s=12_000.0))
        assert s.stats().demand_units == 1  # before any P measurement
        collect(s)
        st = s.stats()
    assert st.demand_units >= 2  # ceil(target/P) ~ 2, and shares follow
    assert st.worker_samples_per_s > 0


# -- the port's own cases -------------------------------------------------------


@pytest.mark.parametrize("mode", [dict(megabatch=2), dict(autotune=True, lookahead=2),
                                  dict(megabatch=3, lookahead=3)],
                         ids=["megabatch2", "autotune", "megabatch3-lookahead3"])
def test_staged_sessions_bitwise_serial_through_one_dispatch_pair(rm1, mode, monkeypatch):
    """Megabatched, autotuned and deep-lookahead sessions deliver the port's
    serial batches bitwise, and every chunk, K = 1 included, goes through
    the engine's one dispatch pair (``launch``, then ``deliver``)."""
    spec, store, _engine, serial = rm1
    engine = TorchPreStoEngine(spec, device="cpu")
    widths, waits = [], []
    launch, deliver = engine.launch, engine.deliver

    def counted_launch(pinned):
        widths.append(int(pinned["label_words"].shape[0]))
        return launch(pinned)

    def counted_deliver(done):
        waits.append(done)
        return deliver(done)

    monkeypatch.setattr(engine, "launch", counted_launch)
    monkeypatch.setattr(engine, "deliver", counted_deliver)
    with PreprocessingService(num_workers=2) as svc:
        s = svc.submit(JobSpec(name="staged", partitions=range(N_PARTS),
                               engine=engine, store=store, units=2, **mode))
        got = collect(s)
        st = s.stats()
    assert_bitwise(got, serial, str(mode))
    assert st.done and st.produced == N_PARTS
    assert sum(widths) == N_PARTS and len(waits) == len(widths)
    assert waits == [None] * len(waits)  # on the CPU a launch returns complete
    k_cap = DEFAULT_AUTOTUNE_KMAX if mode.get("autotune") else mode["megabatch"]
    assert max(widths) <= k_cap


def test_page_nbytes_equal_reference_and_lookahead_prestages(rm1, reference):
    """Pre-staging sizes pages from the torch dtypes' item sizes: the same
    bytes as the reference's uint32 pages for the same spec and rows, so a
    lookahead of 2 pre-stages (a torch dtype given to ``np.dtype`` would
    raise, and the size would fall to 0 and switch pre-staging off)."""
    spec, store, engine, serial = rm1
    jengine, jstore, _ = reference
    svc, jsvc = PreprocessingService(num_workers=1, start=False), JService(
        num_workers=1, start=False)
    try:
        port = svc.submit(JobSpec(name="sized", partitions=range(4), engine=engine,
                                  store=store, lookahead=2))
        ref = jsvc.submit(JJobSpec(name="sized", partitions=range(4), engine=jengine,
                                   store=jstore, lookahead=2))
    finally:
        svc.close()
        jsvc.close()
    assert port._page_nbytes == ref._page_nbytes > 0
    assert port._page_nbytes == sum(v.nbytes for v in engine.stage_partition(store, 0).values())

    with PreprocessingService(num_workers=1) as svc:
        s = svc.submit(JobSpec(name="ahead", partitions=range(N_PARTS), engine=engine,
                               store=store, units=1, queue_depth=N_PARTS, lookahead=2,
                               megabatch=2))
        got = collect(s)
        st = s.stats()
    assert_bitwise(got, serial, "lookahead=2")
    assert 0 < st.staged_bytes_peak <= 256 << 20
    assert st.staged_bytes_peak % port._page_nbytes == 0


def test_jobspec_without_device_runs_on_cuda_and_raises_without_it(rm1, monkeypatch):
    """A JobSpec with a spec and no device builds its engine on CUDA, as
    every entry point of the port does, so with no card present submitting
    it raises; an engine passed in keeps its own device."""
    spec, store, engine, serial = rm1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = JobSpec(name="nodevice", partitions=range(2), spec=spec, store=store)
    assert job.device is None
    with PreprocessingService(num_workers=1) as svc:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            svc.submit(job)
        s = svc.submit(JobSpec(name="cpu-spec", partitions=range(2), spec=spec,
                               store=store, device="cpu"))
        assert s.engine.device == torch.device("cpu")
        assert_bitwise(collect(s), {p: serial[p] for p in range(2)}, "device=cpu")
        s2 = svc.submit(JobSpec(name="own-engine", partitions=range(2), engine=engine,
                                store=store, device="cuda"))
        assert s2.engine is engine and s2.engine.device == torch.device("cpu")
        collect(s2)
