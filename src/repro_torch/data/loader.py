"""Host-side async loading: work queue + straggler re-issue + per-session queues.

The port's own copy of ``repro.data.loader`` (pure Python).  Producers run
on the loader's threads: a produce function that launches CUDA work must
wait for it before returning, as ``TorchPreStoEngine.produce_batch`` does.

The producer-consumer model of the paper's software architecture (Fig. 9):
preprocessing workers fill an input queue that the train manager drains.  At
fleet scale a slow storage device (straggler) must not stall the queue, so
the work queue supports *speculative re-issue*: if a claimed partition has
not completed within `straggler_timeout`, another worker may claim a backup
copy; first completion wins, duplicates are dropped (partitions are
deterministic, so duplicate results are identical — re-issue is always safe).

Two delivery mechanisms sit on top of ``WorkQueue``:

* ``PrefetchLoader``  — the single-tenant convenience: private threads owned
  by one consumer, delivering batches in completion order.
* ``SessionQueue``    — the multi-tenant generalization used by
  ``core.service.PreprocessingService``: production is done by EXTERNAL pool
  workers shared across sessions; delivery is a stream of futures in claim
  order, and fresh claims are refused while ``depth`` futures are undelivered
  (backpressure) — straggler re-issues stay allowed so liveness never depends
  on a slow consumer.  An optional ``lookup`` hook (the shared
  ``core.featcache.FeatureCache`` probe) short-circuits claims whose batch
  is already cached: the future resolves without a produce.

Both queues are device-aware when given an ``owner_of`` mapping: claims
prefer partitions owned by the claimer's own ISP device and fall back to
host placement only when the caller's ``fallback_ok`` predicate admits it
(see ``core.service`` for the contention-aware policy).  Routing never
changes batch bytes — only where/when they are produced.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Deque, Dict, Iterable, Optional, Tuple


class WorkQueue:
    """Partition work queue with straggler re-issue (backup tasks).

    With an ``owner_of`` mapping (pid -> storage device), claims become
    locality-aware: a claimer may prefer partitions owned by ITS device
    (``prefer_device``) and take foreign partitions only when the caller's
    ``fallback_ok`` predicate admits them (typically: the owning device's
    queue is past the host-fallback threshold, or the device has no bound
    unit at all).  FIFO order is preserved within each preference class.
    """

    def __init__(
        self,
        partition_ids: Iterable[int],
        straggler_timeout: float = 30.0,
        *,
        owner_of: Optional[Callable[[int], int]] = None,
        on_reissue: Optional[Callable[[int], None]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        # dedup, order-preserving: a repeated pid would complete once and then
        # be dropped as a straggler duplicate, stranding its consumer forever
        self._pending: Deque[int] = collections.deque(dict.fromkeys(partition_ids))
        # Membership is authoritative in _pending_set; the deques are ORDER
        # indexes with lazy deletion: a pid popped through one index stays in
        # the other as a tombstone and is skipped when reached.  This makes
        # device-preferred claims O(1) amortized (pop the device deque's
        # head) instead of a linear rescan of the global deque per claim.
        self._pending_set: set[int] = set(self._pending)
        self._by_dev: Optional[Dict[int, Deque[int]]] = None
        if owner_of is not None:
            self._by_dev = {}
            for pid in self._pending:
                self._by_dev.setdefault(owner_of(pid), collections.deque()).append(pid)
        self._inflight: Dict[int, float] = {}  # pid -> claim time
        self._done: set[int] = set()
        # Fault-retry state: a pid whose produce hit a retryable I/O fault
        # is `requeue`d — back to pending, optionally embargoed until a
        # backoff deadline, and marked in _requeued so claims may take it
        # even under backpressure (its future already exists; re-claiming
        # it can never grow the consumer's undelivered window, and the
        # stream's head future may be exactly this pid — liveness).
        self._embargo: Dict[int, float] = {}  # pid -> claimable-at instant
        self._requeued: set[int] = set()
        self._lock = threading.Lock()
        self.straggler_timeout = straggler_timeout
        # Injectable time source (``core.simclock.VirtualClock.now`` under the
        # discrete-event simulator): every inflight stamp, straggler deadline
        # and expiry back-date reads THIS clock, so a virtual-time run makes
        # straggler re-issue deterministic instead of wall-clock-raced.
        self._clock: Callable[[], float] = clock or time.monotonic
        self.owner_of = owner_of
        # control-plane observer: called with the pid of every straggler
        # re-issue, OUTSIDE the queue lock (it may emit events / take other
        # locks); a broken observer never breaks the claim path
        self.on_reissue = on_reissue
        self.reissues = 0
        self.requeues = 0  # fault retries returned to the pending pool
        self.total = len(self._pending)  # distinct partitions at creation

    def remaining(self) -> int:
        """Partitions not yet completed (pending + inflight), under the lock."""
        with self._lock:
            return len(self._pending_set) + len(self._inflight)

    def is_pending(self, pid: int) -> bool:
        """True while `pid` is claimable (not yet claimed or completed)."""
        with self._lock:
            return pid in self._pending_set

    def pending_snapshot(self) -> list:
        """Pending pids in claim order (fresh-claim FIFO), tombstones skipped."""
        with self._lock:
            return [p for p in self._pending if p in self._pending_set]

    def peek_ahead(self, n: int, *, prefer_device: Optional[int] = None) -> list:
        """The first `n` pending pids in the order fresh claims would take
        them, WITHOUT claiming: the preferred device's own partitions first
        (when device routing is bound), then the global FIFO.  A pure
        snapshot — nothing is marked inflight, backpressure is untouched —
        so lookahead prefetchers can stage reads and pre-warm caches for
        future claims while never racing the claim path for ownership."""
        if n <= 0:
            return []
        out: list = []
        seen: set[int] = set()
        with self._lock:
            if prefer_device is not None and self._by_dev is not None:
                for pid in self._by_dev.get(prefer_device, ()):
                    if pid in self._pending_set and pid not in seen:
                        out.append(pid)
                        seen.add(pid)
                        if len(out) >= n:
                            return out
            for pid in self._pending:
                if pid in self._pending_set and pid not in seen:
                    out.append(pid)
                    seen.add(pid)
                    if len(out) >= n:
                        break
        return out

    def next_deadline(self) -> Optional[float]:
        """Earliest instant anything becomes claimable again: an inflight
        claim going straggler-overdue, or an embargoed fault-retry's backoff
        expiring (on this queue's clock — ``time.monotonic`` unless
        injected); None when neither applies.  Idle claimers sleep until
        this instant instead of polling."""
        with self._lock:
            deadlines = []
            if self._inflight:
                deadlines.append(
                    min(self._inflight.values()) + self.straggler_timeout
                )
            if self._embargo:
                deadlines.append(min(self._embargo.values()))
            return min(deadlines) if deadlines else None

    def _claimable(self, pid: int, now: float) -> bool:
        """Pending and past any fault-retry backoff embargo."""
        if pid not in self._pending_set:
            return False
        until = self._embargo.get(pid)
        return until is None or now >= until

    def _claimed(self, pid: int) -> None:
        """Bookkeeping for a pid leaving the pending pool."""
        self._pending_set.discard(pid)
        self._embargo.pop(pid, None)
        self._requeued.discard(pid)

    def _pop(self, dq: Optional[Deque[int]], now: float) -> Optional[int]:
        """Pop the first claimable pid off an order index, discarding
        tombstones (pids already popped through the other index).  An
        embargoed pid rotates to the back instead of being dropped — the
        bounded loop guarantees termination when everything is embargoed."""
        if dq is None:
            return None
        for _ in range(len(dq)):
            pid = dq.popleft()
            if pid not in self._pending_set:
                continue  # tombstone: discard
            if self._claimable(pid, now):
                self._claimed(pid)
                return pid
            dq.append(pid)  # embargoed: keep for a later round
        return None

    def _take_first(
        self, pred: Callable[[int], bool], now: float
    ) -> Optional[int]:
        """First claimable pid matching `pred`, global FIFO order.  The
        popped pid is left in the deques as a tombstone (membership alone
        decides pending-ness).  Linear, but only the rare host-fallback and
        fault-retry scans use it — the device-local hot path pops its own
        index in O(1)."""
        for pid in self._pending:
            if self._claimable(pid, now) and pred(pid):
                self._claimed(pid)
                return pid
        return None

    def claim(
        self,
        *,
        reissue_only: bool = False,
        prefer_device: Optional[int] = None,
        fallback_ok: Optional[Callable[[int], bool]] = None,
    ) -> Optional[int]:
        """Claim a partition; FIFO over pending, then straggler re-issue.

        ``reissue_only=True`` skips fresh claims (used by backpressured
        sessions: no new work may start, but an overdue straggler may still
        be backed up so the stream's head future always resolves).  Fault
        RETRIES (``requeue``d pids) are exempt from that gate for the same
        liveness reason: their futures already exist — the stream's blocked
        head may be exactly the requeued pid, and re-claiming it never grows
        the undelivered window.

        ``prefer_device`` (with an ``owner_of`` bound) restricts fresh
        claims to that device's own partitions, then to partitions
        ``fallback_ok`` admits; a foreign partition neither local nor
        fallback-eligible is left for its own device's unit.  Straggler
        re-issue ignores locality — liveness beats placement.
        """
        reissued: Optional[int] = None
        try:
            with self._lock:
                now = self._clock()
                pid: Optional[int] = None
                if self._pending_set and not reissue_only:
                    if prefer_device is None or self.owner_of is None or self._by_dev is None:
                        pid = self._pop(self._pending, now)
                    else:
                        owner = self.owner_of
                        pid = self._pop(self._by_dev.get(prefer_device), now)
                        if pid is None and fallback_ok is not None:
                            # the offload verdict depends only on the OWNING
                            # device (manned? queue past threshold?), so cache
                            # it per device for this scan instead of re-pricing
                            # every pending pid under the lock
                            verdicts: Dict[int, bool] = {}

                            def _ok(p: int) -> bool:
                                d = owner(p)
                                if d not in verdicts:
                                    verdicts[d] = bool(fallback_ok(p))
                                return verdicts[d]

                            pid = self._take_first(_ok, now)
                elif self._requeued and reissue_only:
                    # backpressure bypass for fault retries (see docstring);
                    # locality is ignored — liveness beats placement, like
                    # straggler re-issue
                    pid = self._take_first(self._requeued.__contains__, now)
                if pid is not None:
                    self._inflight[pid] = now
                    return pid
                # steal: re-issue the longest-overdue inflight partition
                overdue = [
                    (t, p)
                    for p, t in self._inflight.items()
                    if now - t > self.straggler_timeout and p not in self._done
                ]
                if overdue:
                    overdue.sort()
                    _, pid = overdue[0]
                    self._inflight[pid] = now
                    self.reissues += 1
                    reissued = pid
                    return pid
                return None
        finally:
            if reissued is not None and self.on_reissue is not None:
                try:
                    self.on_reissue(reissued)
                except Exception:
                    pass

    def expire(self, pid: int) -> bool:
        """Force an inflight claim straggler-overdue NOW.

        The control plane's crash hook: a dead worker's claim must not wait
        out the full ``straggler_timeout``, so its inflight stamp is
        back-dated past the deadline and the very next claim round re-issues
        it through the normal straggler path (same future, same bytes —
        partitions are deterministic, so re-issue is always safe).  A
        completion that raced ahead wins as usual.  Returns True if the pid
        was actually inflight."""
        with self._lock:
            if pid in self._inflight and pid not in self._done:
                self._inflight[pid] = (
                    self._clock() - self.straggler_timeout - 1.0
                )
                return True
            return False

    def requeue(self, pid: int, delay: float = 0.0) -> bool:
        """Return a failed inflight claim to the pending pool (fault retry).

        The claim-path recovery policy's hook: a produce that died on a
        retryable I/O fault re-queues its pid instead of failing the future
        — back of the FIFO (and its device index), embargoed for ``delay``
        seconds of backoff on this queue's clock, and marked requeued so
        backpressured sessions may still re-claim it (its future already
        exists; see ``claim``).  Returns False without touching anything if
        the pid is already done or already pending (a duplicate claim's
        loser — the twin's retry or completion is in motion)."""
        with self._lock:
            if (
                pid in self._done
                or pid in self._pending_set
                or pid not in self._inflight
            ):
                return False
            del self._inflight[pid]
            self._pending_set.add(pid)
            self._pending.append(pid)
            if self._by_dev is not None and self.owner_of is not None:
                self._by_dev.setdefault(
                    self.owner_of(pid), collections.deque()
                ).append(pid)
            self._requeued.add(pid)
            if delay > 0:
                self._embargo[pid] = self._clock() + delay
            self.requeues += 1
            return True

    def complete(self, pid: int) -> bool:
        """Returns True if this completion is the winner (not a duplicate)."""
        with self._lock:
            if pid in self._done:
                return False
            self._done.add(pid)
            self._inflight.pop(pid, None)
            return True

    @property
    def exhausted(self) -> bool:
        with self._lock:
            return not self._pending_set and not self._inflight


class SessionQueue:
    """Per-session queues for a shared preprocessing pool.

    The claim/complete bookkeeping (straggler re-issue, duplicate drop) stays
    in ``WorkQueue``; production is done by external pool workers.  The first
    claim of a partition enqueues a ``Future`` on ``out`` (so delivery is in
    claim order); re-issued claims reuse the existing future and the first
    ``complete`` wins.  Backpressure: ``claim`` refuses fresh work while
    ``depth`` claims are undelivered (``mark_delivered`` is the consumer's
    pacing signal), so at most ``depth`` produced batches are ever held in
    service-side structures.
    """

    def __init__(
        self,
        partition_ids: Iterable[int],
        *,
        depth: int = 4,
        straggler_timeout: float = 30.0,
        lookup: Optional[Callable[[int, bool], Any]] = None,
        owner_of: Optional[Callable[[int], int]] = None,
        fallback_ok: Optional[Callable[[int], bool]] = None,
        on_settled: Optional[Callable[[int], None]] = None,
        on_offload: Optional[Callable[[int], None]] = None,
        on_reissue: Optional[Callable[[int], None]] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.work = WorkQueue(
            partition_ids, straggler_timeout, owner_of=owner_of,
            on_reissue=on_reissue, clock=clock,
        )
        self.depth = depth
        self.out: "queue.Queue[Future]" = queue.Queue()
        self._futures: Dict[int, Future] = {}  # claimed, not yet completed
        self._lock = threading.Lock()
        self.cancelled = threading.Event()
        self.total = self.work.total
        self._created = 0
        self._delivered = 0
        # feature-cache probe: lookup(pid, fresh) -> None (produce), a batch
        # (cached: complete immediately, no produce), or a Future (another
        # tenant is producing this content: complete when it resolves).  The
        # claim loop continues past short-circuited pids so the caller only
        # ever receives a pid that actually needs a produce.
        self.lookup = lookup
        self.short_circuits = 0
        # device routing: owner_of maps pid -> owning device, fallback_ok
        # admits foreign pids (queue past threshold / unmanned device),
        # on_settled(pid) fires once per pid on winner completion (backlog
        # release), on_offload(pid) fires when a fresh claim is routed to
        # the host (the pid stops waiting on its device)
        self.fallback_ok = fallback_ok
        self.on_settled = on_settled
        self.on_offload = on_offload
        self.host_fallbacks = 0  # fresh claims routed off their device

    def claim(
        self, prefer_device: Optional[int] = None
    ) -> Optional[Tuple[int, Future, Optional[str]]]:
        """Pool-worker side: claim (pid, future, route), or None if idle.

        ``route`` is ``None`` (no device routing), ``"isp"`` (produce on the
        pid's owning device) or ``"host"`` (host-fallback produce: pages over
        the link, compute off-device).  Routing NEVER changes the produced
        bytes — only where/when they are accounted.

        With a ``lookup`` bound, every claimed pid is probed first: cached
        claims complete immediately, claims whose content another tenant is
        already producing pend on that tenant's future (winner semantics
        throughout — a re-issued claim whose twin is still producing resolves
        from cache and the straggler's own result is dropped as a duplicate),
        and claiming continues so the worker only ever receives a pid that
        actually needs a produce."""
        while True:
            with self._lock:
                if self.cancelled.is_set():
                    return None
                backpressured = self._created - self._delivered >= self.depth
                pid = self.work.claim(
                    reissue_only=backpressured,
                    prefer_device=prefer_device,
                    fallback_ok=self.fallback_ok,
                )
                if pid is None:
                    return None
                fut = self._futures.get(pid)
                fresh = fut is None
                if fresh:
                    fut = Future()
                    fut.set_running_or_notify_cancel()
                    self._futures[pid] = fut
                    self._created += 1
                    self.out.put(fut)
            route: Optional[str] = None
            if self.work.owner_of is not None:
                owner = self.work.owner_of(pid)
                local = prefer_device is None or owner == prefer_device
                route = "isp" if local else "host"
            if self.lookup is not None:
                try:
                    found = self.lookup(pid, fresh)
                except Exception:
                    found = None  # a broken cache probe degrades to a miss
                if isinstance(found, Future):
                    self._pend(pid, found)
                    continue
                if found is not None:
                    if self.complete(pid, found):
                        with self._lock:
                            self.short_circuits += 1
                    continue
            if fresh and route == "host":
                # counted only for claims that actually reach a produce —
                # a cache short-circuit above needs no fallback at all
                with self._lock:
                    self.host_fallbacks += 1
                if self.on_offload is not None:
                    self.on_offload(pid)
            return pid, fut, route

    def _pend(self, pid: int, donor: Future) -> None:
        """Resolve `pid` from another tenant's in-flight produce of the same
        content.  If the donor is cancelled (leader dropped without a
        result), nothing completes here — the pid stays inflight and the
        straggler timeout re-issues it to a real produce."""

        def _done(d: Future) -> None:
            if d.cancelled():
                return
            exc = d.exception()
            if exc is not None:
                self.complete_error(pid, exc)
            # shallow copy: every follower gets its own batch dict (array
            # buffers stay shared — they are immutable)
            elif self.complete(pid, dict(d.result())):
                with self._lock:
                    self.short_circuits += 1

        donor.add_done_callback(_done)

    def peek_ahead(
        self, n: int, prefer_device: Optional[int] = None
    ) -> list:
        """Non-claiming window over this session's upcoming fresh claims,
        in the order ``claim`` would take them.  Safe to call from any
        worker at any time: nothing is claimed, created, or backpressured —
        it is the oracle a lookahead prefetcher / cache pre-warmer reads to
        stage work for claims that have not happened yet."""
        if self.cancelled.is_set():
            return []
        return self.work.peek_ahead(n, prefer_device=prefer_device)

    def mark_delivered(self) -> None:
        """Consumer pacing signal: one claimed batch has left the stream."""
        with self._lock:
            self._delivered += 1

    def expire(self, pid: int) -> bool:
        """Force `pid`'s inflight claim immediately re-issuable (a dead
        worker held it); see ``WorkQueue.expire``."""
        return self.work.expire(pid)

    def requeue(self, pid: int, delay: float = 0.0) -> bool:
        """Return `pid` to the pending pool for a fault retry with `delay`
        seconds of backoff; its existing future stays pending and resolves
        when a later claim produces (or quarantines) it.  See
        ``WorkQueue.requeue``."""
        return self.work.requeue(pid, delay)

    def complete(self, pid: int, batch: Any) -> bool:
        """First completion wins and resolves the future; duplicates dropped."""
        if not self.work.complete(pid):
            return False
        self._settle(pid)
        with self._lock:
            # drop our reference: once delivered, the batch's lifetime is the
            # consumer's (memory stays bounded by depth, not job size)
            fut = self._futures.pop(pid)
        fut.set_result((pid, batch))
        return True

    def complete_error(self, pid: int, exc: BaseException) -> bool:
        """Propagate a producer failure to the consumer (winner-only)."""
        if not self.work.complete(pid):
            return False
        self._settle(pid)
        with self._lock:
            fut = self._futures.pop(pid)
        fut.set_exception(exc)
        return True

    def _settle(self, pid: int) -> None:
        """Winner-only settle hook (device backlog release); never lets an
        accounting callback break the delivery path."""
        if self.on_settled is not None:
            try:
                self.on_settled(pid)
            except Exception:
                pass

    @property
    def exhausted(self) -> bool:
        return self.work.exhausted

    def cancel(self) -> None:
        self.cancelled.set()


class PrefetchLoader:
    """Threaded prefetching producer: keeps `depth` ready batches queued.

    produce_fn(partition_id) -> batch.  Batches are delivered in completion
    order (training is order-agnostic across partitions, like the paper's
    mini-batch queue).
    """

    def __init__(
        self,
        partition_ids: Iterable[int],
        produce_fn: Callable[[int], Any],
        num_workers: int = 2,
        depth: int = 4,
        straggler_timeout: float = 30.0,
    ):
        self.work = WorkQueue(partition_ids, straggler_timeout)
        self.produce_fn = produce_fn
        self.out: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._threads = [
            threading.Thread(target=self._run, daemon=True) for _ in range(num_workers)
        ]
        self._stop = threading.Event()
        # Idle-worker wakeups: a worker with nothing claimable sleeps on this
        # condition until a completion changes claimability (straggler gone /
        # queue exhausted), the next straggler deadline passes, or stop() —
        # no polling loop burning CPU while partitions are in flight
        # elsewhere.
        self._idle_cv = threading.Condition()
        self._started = False
        self._produced = 0
        self._total = self.work.total

    def start(self) -> "PrefetchLoader":
        self._started = True
        for t in self._threads:
            t.start()
        return self

    def _wake_idle(self) -> None:
        with self._idle_cv:
            self._idle_cv.notify_all()

    def _run(self) -> None:
        while not self._stop.is_set():
            pid = self.work.claim()
            if pid is None:
                if self.work.exhausted:
                    return
                # Nothing claimable: every pending pid is inflight elsewhere
                # and none is overdue yet.  Sleep until a completion notifies
                # us or the earliest straggler deadline arrives — whichever
                # first — instead of spin-polling.
                deadline = self.work.next_deadline()
                with self._idle_cv:
                    if self._stop.is_set() or self.work.exhausted:
                        continue
                    if deadline is None:
                        self._idle_cv.wait(timeout=0.05)  # claim/wait race
                    else:
                        self._idle_cv.wait(
                            timeout=max(0.0, deadline - time.monotonic())
                        )
                continue
            batch = self.produce_fn(pid)
            won = self.work.complete(pid)  # drop duplicate straggler results
            self._wake_idle()  # claimability / exhaustion changed
            if won:
                # Timed put: a plain blocking put() would ignore stop()
                # forever when the consumer goes away with the queue full.
                while not self._stop.is_set():
                    try:
                        self.out.put((pid, batch), timeout=0.05)
                        break
                    except queue.Full:
                        continue

    def __iter__(self):
        if not self._started:
            self.start()
        while self._produced < self._total:
            try:
                pid, batch = self.out.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return
                # Liveness: if every worker has exited but work is undone and
                # nothing is queued, a worker died mid-produce — blocking on
                # get() forever would hang the trainer.
                if (
                    not any(t.is_alive() for t in self._threads)
                    and self.out.empty()
                ):
                    if self.work.remaining() == 0:
                        return  # nothing left and nothing queued: clean end
                    raise RuntimeError(
                        "PrefetchLoader workers exited with "
                        f"{self.work.remaining()} partitions unfinished"
                    )
                continue
            self._produced += 1
            yield pid, batch

    def stop(self) -> None:
        self._stop.set()
        self._wake_idle()
        me = threading.current_thread()
        for t in self._threads:
            if t.is_alive() and t is not me:
                t.join(timeout=5.0)
