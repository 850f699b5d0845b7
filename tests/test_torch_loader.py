"""The port's work queues and prefetch loader.

``WorkQueue`` runs the reference's model-based invariant driver
(``tests/workqueue_model.py``) with the port's class put in place of the
reference's: the same interleavings, hypothesis-drawn and seeded, against
the same model.  The loader's threads drive the port's engine as the
service of a later slice will: each call selects the engine's device,
stages into its own buffers and waits for its own batch.
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

import workqueue_model
from repro.data import loader as jloader
from repro_torch.configs.registry import get_recsys
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.loader import PrefetchLoader, SessionQueue, WorkQueue
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource

hypothesis = pytest.importorskip("hypothesis", reason="dev-only dependency")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

_settings = settings(max_examples=25, deadline=None, derandomize=True)
_DEVICES = 3


@contextlib.contextmanager
def _port_queue():
    """Run the model's driver against the port's WorkQueue."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(workqueue_model, "WorkQueue", WorkQueue)
        yield


def test_model_driver_builds_the_port_queue():
    with _port_queue():
        wq = workqueue_model.apply_ops([("claim", False, None, False)], partitions=3)
    assert type(wq) is WorkQueue and wq.__module__ == "repro_torch.data.loader"
    assert workqueue_model.WorkQueue is jloader.WorkQueue  # restored


def test_work_queue_model_seeded_interleavings():
    rng = np.random.default_rng(2024)
    with _port_queue():
        for _ in range(60):
            parts = int(rng.integers(1, 20))
            devs = int(rng.integers(1, 5))
            ops = workqueue_model.random_ops(rng, int(rng.integers(0, 60)),
                                             partitions=parts, devices=devs)
            workqueue_model.apply_ops(ops, partitions=parts, devices=devs)


_claim_op = st.tuples(st.just("claim"), st.booleans(),
                      st.one_of(st.none(), st.integers(0, _DEVICES - 1)), st.booleans())
_complete_op = st.tuples(st.just("complete"), st.integers(0, 63))
_expire_op = st.tuples(st.just("expire"), st.integers(0, 63))
_peek_op = st.tuples(st.just("peek"), st.integers(0, 24),
                     st.one_of(st.none(), st.integers(0, _DEVICES - 1)))
_advance_op = st.tuples(st.just("advance"),
                        st.floats(0.0, workqueue_model.TIMEOUT * 1.5, allow_nan=False))
_ops = st.lists(st.one_of(_claim_op, _complete_op, _expire_op, _peek_op, _advance_op),
                max_size=60)


@_settings
@given(ops_seq=_ops, partitions=st.integers(1, 20))
def test_workqueue_interleaving_invariants(ops_seq, partitions):
    with _port_queue():
        workqueue_model.apply_ops(list(ops_seq), partitions=partitions, devices=_DEVICES)


@_settings
@given(ops_seq=_ops, partitions=st.integers(1, 16), n=st.integers(0, 20),
       prefer=st.one_of(st.none(), st.integers(0, _DEVICES - 1)))
def test_workqueue_peek_ahead_never_claims(ops_seq, partitions, n, prefer):
    with _port_queue():
        wq = workqueue_model.apply_ops(list(ops_seq), partitions=partitions,
                                       devices=_DEVICES, drain=False)
    before = (wq.pending_snapshot(), wq.remaining())
    out = wq.peek_ahead(n, prefer_device=prefer)
    assert len(out) == len(set(out)) and len(out) <= max(n, 0)
    assert set(out) <= set(before[0])
    assert (wq.pending_snapshot(), wq.remaining()) == before


@_settings
@given(ops_seq=_ops, partitions=st.integers(1, 16))
def test_workqueue_completed_never_resurrected(ops_seq, partitions):
    with _port_queue():
        wq = workqueue_model.apply_ops(list(ops_seq), partitions=partitions, devices=_DEVICES)
    assert wq.exhausted
    for reissue_only in (False, True):
        for prefer in (None, 0):
            assert wq.claim(reissue_only=reissue_only, prefer_device=prefer,
                            fallback_ok=lambda p: True) is None


# -- test_data.py's queue and loader cases ------------------------------------------


def test_work_queue_straggler_reissue():
    q = WorkQueue([0, 1], straggler_timeout=0.01)
    a, b = q.claim(), q.claim()
    assert {a, b} == {0, 1}
    time.sleep(0.05)
    c = q.claim()
    assert c in (0, 1) and q.reissues == 1
    assert q.complete(c) is True
    assert q.complete(c) is False


def test_prefetch_loader_delivers_all():
    seen = []
    loader = PrefetchLoader(range(10), lambda pid: pid * 10, num_workers=3, depth=2)
    for pid, batch in loader:
        assert batch == pid * 10
        seen.append(pid)
    assert sorted(seen) == list(range(10))


def test_work_queue_fifo_claim_order():
    q = WorkQueue(range(5))
    assert [q.claim() for _ in range(5)] == list(range(5))
    assert q.claim() is None
    assert q.reissues == 0


def test_work_queue_reissue_only_skips_pending():
    q = WorkQueue([0, 1], straggler_timeout=0.0)
    assert q.claim(reissue_only=True) is None
    a = q.claim()
    time.sleep(0.01)
    assert q.claim(reissue_only=True) == a
    assert q.reissues == 1


def test_prefetch_loader_stop_reaps_blocked_workers():
    loader = PrefetchLoader(range(8), lambda pid: pid, num_workers=2, depth=1)
    loader.start()
    time.sleep(0.2)
    t0 = time.time()
    loader.stop()
    assert time.time() - t0 < 2.0
    assert not any(t.is_alive() for t in loader._threads)


def test_work_queue_remaining_public():
    q = WorkQueue([0, 1, 2])
    assert q.total == 3 and q.remaining() == 3
    a = q.claim()
    assert q.remaining() == 3
    q.complete(a)
    assert q.remaining() == 2


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_prefetch_loader_worker_death_raises():
    def explode(pid):
        raise RuntimeError("storage device on fire")

    loader = PrefetchLoader(range(4), explode, num_workers=2, depth=2)
    with pytest.raises(RuntimeError, match="unfinished"):
        for _ in loader:
            pass


# -- test_execcache.py's wakeup cases ---------------------------------------------------


def test_workqueue_next_deadline_tracks_earliest_claim():
    q = WorkQueue([0, 1], straggler_timeout=5.0)
    assert q.next_deadline() is None
    t0 = time.monotonic()
    q.claim()
    ddl = q.next_deadline()
    assert ddl is not None and 4.0 < ddl - t0 <= 5.1
    q.claim()
    assert q.next_deadline() == ddl
    q.complete(0)
    q.complete(1)
    assert q.next_deadline() is None


def test_prefetch_loader_cv_delivers_all_with_slow_producer():
    def produce(pid):
        if pid == 0:
            time.sleep(0.15)
        return pid * 10

    loader = PrefetchLoader(range(6), produce, num_workers=3, depth=2, straggler_timeout=0.05)
    got = dict(loader)
    loader.stop()
    assert got == {pid: pid * 10 for pid in range(6)}
    assert loader.work.reissues >= 1


def test_prefetch_loader_stop_wakes_idle_workers_promptly():
    release = threading.Event()

    def produce(pid):
        if pid == 0:
            release.wait(0.5)
        return pid

    loader = PrefetchLoader([0, 1], produce, num_workers=2, straggler_timeout=30.0).start()
    time.sleep(0.1)
    t0 = time.perf_counter()
    loader.stop()
    release.set()
    assert time.perf_counter() - t0 < 3.0


# -- test_iofaults.py's requeue cases ----------------------------------------------------


def test_workqueue_requeue_embargo_and_deadline():
    t = [0.0]
    q = WorkQueue([0, 1], straggler_timeout=60.0, clock=lambda: t[0])
    assert q.claim() == 0
    assert q.requeue(0, delay=5.0) is True
    assert not q.exhausted
    assert q.claim() == 1
    assert q.claim() is None
    assert q.next_deadline() == 5.0
    t[0] = 5.0
    assert q.claim() == 0 and q.requeues == 1
    q.complete(0)
    q.complete(1)
    assert q.requeue(0) is False
    assert q.exhausted


def test_workqueue_requeue_rejects_pending_and_unclaimed():
    q = WorkQueue([0, 1], straggler_timeout=60.0)
    assert q.requeue(0) is False
    assert q.claim() == 0
    assert q.requeue(0) is True
    assert q.requeue(0) is False


def test_sessionqueue_requeued_claim_bypasses_backpressure():
    sq = SessionQueue([0, 1, 2], depth=1)
    pid, fut, _ = sq.claim()
    assert pid == 0
    assert sq.claim() is None
    assert sq.requeue(0) is True
    pid2, fut2, _ = sq.claim()
    assert pid2 == 0 and fut2 is fut
    assert sq.complete(0, {"labels": np.zeros((1,))})
    assert fut.result()[0] == 0


def test_workqueue_expire_reissues_immediately():
    seen = []
    q = WorkQueue([0, 1], straggler_timeout=60.0, on_reissue=seen.append)
    assert q.claim() == 0
    assert q.expire(0) is True
    assert q.claim() == 1
    assert q.claim() == 0 and q.reissues == 1 and seen == [0]
    assert q.expire(7) is False
    q.complete(0)
    assert q.expire(0) is False


# -- loader threads on the port's engine ------------------------------------------------


def test_loader_threads_drive_the_engine_bitwise_with_one_trace():
    """Four loader threads on one engine (more threads than a small
    sandbox has cores, a short switch interval): every batch is bitwise the
    serial one, and the engine's plan was lowered once, before the threads
    (the port has no jit; nothing is traced or built per call)."""
    import sys

    src = SyntheticRecSysSource(get_recsys("rm1", reduced=True).data, rows=160)
    store = PartitionedStore(12, num_devices=4, source=src)
    engine = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    plan = engine.lowered_plan
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        calls = []  # list.append is atomic: one entry per produce call

        def produce(pid):
            calls.append(pid)
            return engine.produce_batch(store, pid)

        loader = PrefetchLoader(range(12), produce, num_workers=4, depth=2)
        got = dict(loader)
        loader.stop()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in loader._threads)
    assert engine.lowered_plan is plan
    serial = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    assert sorted(got) == list(range(12))
    for pid in range(12):
        want = serial.produce_batch(PartitionedStore(12, 4, src), pid)
        for k in want:
            assert torch.equal(got[pid][k], want[k]), (pid, k)
    # the byte counters lose no update under concurrent reads
    assert store.bytes_read == sum(src.partition(p).nbytes() for p in calls)
