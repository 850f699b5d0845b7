"""Virtual-time discrete-event engine + SLO-aware multi-tenant simulation.

The port's own copy of ``repro.core.simclock``: numpy only, no device.  It
runs over the port's ``WorkQueue``, ``DeviceFleet``,
``ContentionAwareCostModel``, ``plan_pool_slo`` and ``EventLog``, and for
the same seed and schedule it gives the reference's ``trace_bytes()``, byte
for byte.

The contention model (``core.costmodel.ContentionAwareCostModel``) prices
queue depth statically, but a wall-clock bench can never exhibit the
thousand-tenant contention regimes Meta's DSI characterization identifies as
the production bottleneck: real threads cannot be 1000 tenants, and real
sleeps make every race nondeterministic.  This module makes the existing
ledgers busy *in time* instead:

* ``VirtualClock`` / ``SimEngine`` — a classic discrete-event core: an event
  heap ordered by ``(time, seq)`` (seq breaks ties deterministically, so two
  events at the same modeled instant always run in schedule order), a clock
  that jumps from event to event, and no real sleeps anywhere.  A
  1000-session schedule is just tens of thousands of heap pops — wall-clock
  seconds.
* ``SimService`` — the virtual-time twin of
  ``core.service.PreprocessingService``, run over the REAL building blocks:
  claims come from ``data.loader.WorkQueue`` (with the virtual clock
  injected, so straggler re-issue is deterministic), device occupancy is the
  REAL ``data.storage.IspDevice``/``DeviceFleet`` ledgers via their
  ``reserve``/``reserve_host`` virtual-time API, routing prices through the
  same ``ContentionAwareCostModel.should_offload``, and admission/allocation
  is ``core.planner.plan_pool_slo`` (QoS tiers, reject/degrade-instead-of-
  starve, release-candidate preemption) or a FIFO baseline that admits
  everything and starves the tail.  Every decision lands in a
  ``core.ctrlplane.EventLog`` stamped with the VIRTUAL instant — same seed,
  byte-identical trace.
* ``SimHarness`` — the deterministic-simulation test fixture: seeded
  scenario -> report + trace bytes; replaying the seed must reproduce the
  trace byte for byte, which is what the FoundationDB-style tests diff.
  Worker kill/join at modeled instants re-issues in-flight claims through
  the same straggler path the threaded service uses — the previously
  wall-clock-only chaos drills run deterministically here.
* ``zipf_sessions`` — the workload generator: hundreds-to-thousands of
  Zipf-skewed sessions (a few huge jobs, a long tail of small ones), seeded
  arrivals, a release-candidate fraction, and per-session deadlines.

The reference's ``bench_throughput --sim --sessions N`` drives this end to
end; the port has no bench yet, and ``chip_smoke.py`` replays one seeded
schedule twice and compares the traces.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.costmodel import ContentionAwareCostModel, PartitionCosts
from repro_torch.core.ctrlplane import EventLog
from repro_torch.core.planner import (
    QOS_EXPLORATORY,
    QOS_RANK,
    QOS_RELEASE_CANDIDATE,
    DeviceTopology,
    SloRequest,
    plan_pool_slo,
)
from repro_torch.data.loader import WorkQueue
from repro_torch.data.storage import DeviceFleet

__all__ = [
    "SimEngine",
    "SimHarness",
    "SimJob",
    "SimReport",
    "SimService",
    "VirtualClock",
    "synthetic_costs",
    "zipf_sessions",
]


# -- the discrete-event core ---------------------------------------------------


class VirtualClock:
    """Modeled time: a float that only the event loop advances.

    ``now`` is a bound-method time source, drop-in wherever the wall-clock
    paths take a ``clock`` callable (``WorkQueue``, ``EventLog``)."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if t < self._now:
            raise ValueError(f"virtual time cannot rewind: {t} < {self._now}")
        self._now = float(t)

    def sleep(self, dt: float) -> None:
        """Advance modeled time by ``dt`` — the drop-in ``sleep`` callable
        for virtual-clock-aware paths (``IoFaultInjector`` slow reads, the
        claim path's fault-retry backoff), so a simulated run models fault
        latency without ever blocking a real thread."""
        if dt > 0:
            self._now += float(dt)


class SimEngine:
    """Event-heap scheduler over a ``VirtualClock``.

    Events are ``(time, seq, fn)``: the monotone ``seq`` makes same-instant
    events pop in schedule order, so the whole run is a pure function of the
    schedule — the determinism every replay test leans on.  ``rng`` is the
    run's single seeded generator; anything random (workload shapes, chaos
    schedules) must draw from it and only it.
    """

    def __init__(self, seed: int = 0):
        self.clock = VirtualClock()
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self.processed = 0

    @property
    def now(self) -> float:
        return self.clock.now()

    def at(self, t: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` for virtual instant ``t`` (>= now)."""
        if t < self.now:
            raise ValueError(f"cannot schedule into the past: {t} < {self.now}")
        heapq.heappush(self._heap, (float(t), self._seq, fn))
        self._seq += 1

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.now + max(dt, 0.0), fn)

    def step(self) -> bool:
        """Run the earliest event; False when the heap is empty."""
        if not self._heap:
            return False
        t, _, fn = heapq.heappop(self._heap)
        self.clock.advance_to(t)
        self.processed += 1
        fn()
        return True

    def run(self, until: Optional[float] = None) -> int:
        """Drain the heap (optionally stopping past ``until``); returns the
        number of events processed by this call."""
        n0 = self.processed
        while self._heap:
            if until is not None and self._heap[0][0] > until:
                break
            self.step()
        return self.processed - n0


# -- workload ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimJob:
    """One simulated tenant: a partition count plus its SLO contract."""

    name: str
    partitions: int
    arrival_s: float = 0.0
    qos_class: str = QOS_EXPLORATORY
    deadline_s: Optional[float] = None  # relative to arrival
    demand_units: Optional[int] = None  # explicit ceil(T/P); default: size-derived

    @property
    def rank(self) -> int:
        return QOS_RANK.get(self.qos_class, max(QOS_RANK.values()) + 1)


def synthetic_costs(
    model: ContentionAwareCostModel,
    *,
    page_bytes: int = 48 << 20,
    batch_bytes: int = 16 << 20,
    ops: float = 2e7,
    spec=None,
    rows: Optional[int] = None,
) -> PartitionCosts:
    """Self-consistent per-partition costs at the model's modeled rates —
    the byte-bound RecSys regime where in-storage wins: pages stream at the
    device's internal rate instead of crossing the 3 GB/s link.

    Pass ``spec`` (a ``core.spec.TransformSpec``, optionally with ``rows``)
    to CALIBRATE the sim against the real cost model instead of the round
    default constants: the returned costs are ``costmodel.partition_costs``
    for that Transform — including the dedup-aware unique-bytes/ops pricing
    (``RMDataConfig.dup_factor``) — so modeled sim makespans track what the
    threaded service's ledgers would charge for the same partitions.
    """
    if spec is not None:
        from repro_torch.core.costmodel import partition_costs  # lazy: no cycle

        return partition_costs(spec, rows, model)
    isp_s = page_bytes / model.isp_stream_bytes_per_s + ops / model.isp_ops_per_s
    host_s = (page_bytes + batch_bytes) / model.link_bytes_per_s + ops / model.host_ops_per_s
    return PartitionCosts(
        isp_s=isp_s, host_s=host_s, ops=ops,
        page_bytes=page_bytes, batch_bytes=batch_bytes,
    )


def zipf_sessions(
    n: int,
    *,
    rng: np.random.Generator,
    alpha: float = 1.3,
    max_partitions: int = 64,
    rc_fraction: float = 0.1,
    arrival_window_s: float = 60.0,
    per_partition_s: float = 0.011,
    deadline_slack: float = 6.0,
    rc_deadline_slack: float = 4.0,
) -> List[SimJob]:
    """Generate ``n`` Zipf-skewed sessions: a few huge jobs, a long tail of
    small ones (Meta's session-size skew), seeded arrivals over a window, a
    ``rc_fraction`` of release candidates, and per-session deadlines scaled
    to each job's ideal single-unit service time (release candidates get the
    tighter slack — they are the tier the SLO report watches)."""
    sizes = np.minimum(rng.zipf(alpha, size=n), max_partitions).astype(int)
    arrivals = np.sort(rng.uniform(0.0, arrival_window_s, size=n))
    is_rc = rng.random(n) < rc_fraction
    jobs = []
    for i in range(n):
        size = max(1, int(sizes[i]))
        rc = bool(is_rc[i])
        slack = rc_deadline_slack if rc else deadline_slack
        jobs.append(
            SimJob(
                name=f"s{i:05d}",
                partitions=size,
                arrival_s=float(arrivals[i]),
                qos_class=QOS_RELEASE_CANDIDATE if rc else QOS_EXPLORATORY,
                deadline_s=max(slack * size * per_partition_s, 1.0),
                demand_units=min(4, size),
            )
        )
    return jobs


# -- outcomes ------------------------------------------------------------------


@dataclasses.dataclass
class JobOutcome:
    """The sim's verdict on one job — explicit, never silent starvation."""

    name: str
    qos_class: str
    partitions: int
    arrival_s: float
    deadline_s: Optional[float]
    status: str  # "admitted" | "degraded" | "rejected"
    granted_units: int = 0
    finish_s: Optional[float] = None
    reissues: int = 0
    host_fallbacks: int = 0

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_s is None:
            return None
        return self.finish_s - self.arrival_s

    @property
    def slo_met(self) -> Optional[bool]:
        """None for rejected jobs (they have no completion to score)."""
        if self.status == "rejected":
            return None
        if self.deadline_s is None:
            return True
        lat = self.latency_s
        return lat is not None and lat <= self.deadline_s

    def starved(self, factor: float = 10.0) -> bool:
        """An ADMITTED job that blew past ``factor`` x its deadline (or
        never finished) was starved — the outcome SLO-aware admission
        converts into an up-front reject/degrade."""
        if self.status == "rejected":
            return False
        if self.finish_s is None:
            return True
        if self.deadline_s is None:
            return False
        return self.latency_s > factor * self.deadline_s

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "qos_class": self.qos_class,
            "partitions": self.partitions,
            "arrival_s": self.arrival_s,
            "deadline_s": self.deadline_s,
            "status": self.status,
            "granted_units": self.granted_units,
            "finish_s": self.finish_s,
            "latency_s": self.latency_s,
            "slo_met": self.slo_met,
            "reissues": self.reissues,
            "host_fallbacks": self.host_fallbacks,
        }


@dataclasses.dataclass
class SimReport:
    """Whole-schedule summary: per-class SLO attainment + modeled makespan."""

    policy: str
    seed: int
    outcomes: List[JobOutcome]
    makespan_s: float
    events_processed: int
    device_utilization: List[Dict[str, float]]
    host_busy_s: float
    starvation_factor: float = 10.0

    def by_class(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for cls in sorted({o.qos_class for o in self.outcomes}):
            jobs = [o for o in self.outcomes if o.qos_class == cls]
            scored = [o for o in jobs if o.slo_met is not None]
            met = sum(1 for o in scored if o.slo_met)
            lats = sorted(
                o.latency_s for o in jobs if o.latency_s is not None
            )
            out[cls] = {
                "jobs": len(jobs),
                "admitted": sum(1 for o in jobs if o.status == "admitted"),
                "degraded": sum(1 for o in jobs if o.status == "degraded"),
                "rejected": sum(1 for o in jobs if o.status == "rejected"),
                "starved": sum(
                    1 for o in jobs if o.starved(self.starvation_factor)
                ),
                "slo_attainment": met / len(scored) if scored else 1.0,
                "p50_latency_s": lats[len(lats) // 2] if lats else None,
                "p99_latency_s": (
                    lats[min(len(lats) - 1, int(0.99 * len(lats)))] if lats else None
                ),
            }
        return out

    @property
    def starved_count(self) -> int:
        return sum(1 for o in self.outcomes if o.starved(self.starvation_factor))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "policy": self.policy,
            "seed": self.seed,
            "sessions": len(self.outcomes),
            "makespan_s": self.makespan_s,
            "events_processed": self.events_processed,
            "starved": self.starved_count,
            "by_class": self.by_class(),
            "host_busy_s": self.host_busy_s,
            "devices": self.device_utilization,
        }


# -- the virtual-time service --------------------------------------------------


class _SimWorker:
    """One pool unit bound to a device, busy between modeled instants."""

    __slots__ = ("wid", "device", "alive", "busy", "task_seq")

    def __init__(self, wid: int, device: int):
        self.wid = wid
        self.device = device
        self.alive = True
        self.busy = False
        self.task_seq = 0  # bumps per assignment: stale completions drop


class _SimSession:
    """Virtual-time session state: a real WorkQueue + SLO bookkeeping."""

    def __init__(
        self,
        job: SimJob,
        *,
        clock: Callable[[], float],
        owner_of: Callable[[int], int],
        fallback_ok: Callable[["_SimSession", int], bool],
        on_reissue: Callable[[int], None],
        straggler_timeout: float,
    ):
        self.job = job
        self.name = job.name
        self.owner_of = owner_of
        self.work = WorkQueue(
            range(job.partitions),
            straggler_timeout,
            owner_of=owner_of,
            on_reissue=on_reissue,
            clock=clock,
        )
        self._fallback = fallback_ok
        self.share = 0
        self.inflight = 0
        self.status = "admitted"  # live scheduling status (may degrade)
        self.outcome_status = "admitted"  # sticky: degraded once => degraded
        self.delivered = 0
        self.host_fallbacks = 0
        self.finish_s: Optional[float] = None

    def fallback_ok(self, pid: int) -> bool:
        return self._fallback(self, pid)

    @property
    def done(self) -> bool:
        return self.work.exhausted


class SimService:
    """Multi-tenant preprocessing schedule in virtual time — no sleeps.

    The claim/produce path mirrors ``core.service.PreprocessingService``:
    pool units bound round-robin to devices, locality-first claims with
    contention-aware host fallback, straggler re-issue on kill, QoS-tiered
    shares.  Where the threaded service blocks a worker on a real produce,
    the sim reserves the owning device's ledger *in time*
    (``IspDevice.reserve``) and schedules the completion event at the
    modeled instant — so a thousand tenants cost heap pops, not threads.

    ``policy="slo"``: admission via ``core.planner.plan_pool_slo`` —
    reject/degrade instead of starve, release candidates first.
    ``policy="fifo"``: the baseline — everything is admitted and served in
    strict arrival order; under load the tail starves, which is exactly the
    contrast the SLO report quantifies.
    """

    def __init__(
        self,
        engine: SimEngine,
        *,
        num_workers: int = 8,
        num_devices: int = 4,
        host_parallelism: int = 2,
        policy: str = "slo",
        cost_model: Optional[ContentionAwareCostModel] = None,
        costs: Optional[
            "PartitionCosts | Callable[[SimJob, int], PartitionCosts]"
        ] = None,
        owner_of: Optional[Callable[[SimJob, int], int]] = None,
        straggler_timeout: float = 1e9,
        event_capacity: int = 1 << 20,
    ):
        assert policy in ("slo", "fifo"), policy
        self.engine = engine
        self.policy = policy
        self.cost_model = cost_model or ContentionAwareCostModel()
        self.fleet = DeviceFleet.from_cost_model(
            max(1, num_devices), self.cost_model
        )
        self.host_parallelism = max(1, host_parallelism)
        self._costs = costs or synthetic_costs(self.cost_model)
        self._owner_fn = owner_of
        self.straggler_timeout = straggler_timeout
        self.events = EventLog(event_capacity, clock=engine.clock.now)
        self.workers: List[_SimWorker] = [
            _SimWorker(w, w % len(self.fleet)) for w in range(max(1, num_workers))
        ]
        self.sessions: List[_SimSession] = []  # active, arrival order
        self.outcomes: Dict[str, JobOutcome] = {}
        self._job_index: Dict[str, int] = {}
        self._submitted = 0
        # wid -> (session, pid, route, owner) for the claim each busy worker
        # holds: a kill must expire exactly that claim back onto the
        # straggler path, nothing else
        self._held: Dict[int, Tuple[_SimSession, int, str, int]] = {}

    # -- inputs ----------------------------------------------------------------

    def costs_of(self, job: SimJob, pid: int) -> PartitionCosts:
        c = self._costs
        return c(job, pid) if callable(c) else c

    def _owner(self, job: SimJob, pid: int) -> int:
        if self._owner_fn is not None:
            return self._owner_fn(job, pid)
        # default: spread each job's partitions from a job-specific offset,
        # so concurrent tenants don't all hammer device 0 first
        return (self._job_index[job.name] + pid) % len(self.fleet)

    def submit(self, job: SimJob) -> None:
        """Schedule a job's arrival at its virtual instant."""
        self._job_index.setdefault(job.name, self._submitted)
        self._submitted += 1
        self.engine.at(max(job.arrival_s, self.engine.now), lambda: self._arrive(job))

    def submit_all(self, jobs: List[SimJob]) -> None:
        for j in jobs:
            self.submit(j)

    # -- chaos -----------------------------------------------------------------

    def kill_worker_at(self, t: float, wid: int) -> None:
        self.engine.at(t, lambda: self.kill_worker(wid))

    def join_worker_at(self, t: float, device: Optional[int] = None) -> None:
        self.engine.at(t, lambda: self._join(device))

    def kill_worker(self, wid: int) -> None:
        """Kill at the current virtual instant: the worker's in-flight claim
        is force-expired back onto the straggler path (its scheduled
        completion event goes stale via the task_seq bump and is dropped),
        capacity shrinks, and shares re-plan — the same crash drill the
        threaded service runs, now deterministic."""
        w = next((x for x in self.workers if x.wid == wid and x.alive), None)
        if w is None:
            return
        held = self._held.pop(wid, None)
        w.alive = False
        w.task_seq += 1  # in-flight completion (if any) is now stale
        self.events.emit("kill", wid=wid, device=w.device)
        if held is not None:
            sess, pid, route, owner = held
            sess.inflight -= 1
            if route == "isp":
                self.fleet[owner].end_claim()
            if sess.work.expire(pid):
                self.events.emit("claim_expired", job=sess.name, pid=pid)
        self._replan(trigger="kill")
        self._dispatch_idle()

    def _join(self, device: Optional[int]) -> None:
        if device is None:
            counts = {d: 0 for d in range(len(self.fleet))}
            for w in self.workers:
                if w.alive:
                    counts[w.device] += 1
            device = min(counts, key=lambda d: (counts[d], d))
        wid = max((w.wid for w in self.workers), default=-1) + 1
        self.workers.append(_SimWorker(wid, device))
        self.events.emit("join", wid=wid, device=device)
        self._replan(trigger="join")
        self._dispatch_idle()

    # -- admission -------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return sum(1 for w in self.workers if w.alive)

    def _topology(self) -> DeviceTopology:
        upd = {d: 0 for d in range(len(self.fleet))}
        for w in self.workers:
            if w.alive:
                upd[w.device] += 1
        return DeviceTopology(upd)

    def _manned(self) -> set:
        return self._topology().manned

    def _arrive(self, job: SimJob) -> None:
        self.events.emit(
            "job_arrive", job=job.name, qos_class=job.qos_class,
            partitions=job.partitions, deadline_s=job.deadline_s,
        )
        outcome = JobOutcome(
            name=job.name, qos_class=job.qos_class, partitions=job.partitions,
            arrival_s=self.engine.now, deadline_s=job.deadline_s,
            status="admitted",
        )
        self.outcomes[job.name] = outcome
        if self.policy == "slo":
            reqs = [
                SloRequest(s.name, self._demand(s.job), s.job.qos_class,
                           s.job.deadline_s)
                for s in self.sessions
            ]
            reqs.append(
                SloRequest(job.name, self._demand(job), job.qos_class,
                           job.deadline_s)
            )
            _plan, decisions = plan_pool_slo(self.capacity, reqs)
            mine = decisions[job.name]
            if mine.status == "rejected":
                outcome.status = "rejected"
                self.events.emit(
                    "reject", job=job.name, qos_class=job.qos_class,
                    reason=mine.reason,
                )
                return
            outcome.status = mine.status
            outcome.granted_units = mine.granted_units
            self._admit(job)
            self._apply_decisions(decisions, joining=job.name)
        else:
            outcome.granted_units = 1
            self._admit(job)
            self.events.emit("admit", job=job.name, status="admitted", units=1)
        self._dispatch_idle()

    def _demand(self, job: SimJob) -> int:
        if job.demand_units is not None:
            return max(1, int(job.demand_units))
        return max(1, min(4, int(math.ceil(job.partitions / 4))))

    def _admit(self, job: SimJob) -> None:
        sess = _SimSession(
            job,
            clock=self.engine.clock.now,
            owner_of=lambda pid, j=job: self._owner(j, pid),
            fallback_ok=self._fallback_ok,
            on_reissue=lambda pid, name=job.name: self.events.emit(
                "claim_reissue", job=name, pid=pid
            ),
            straggler_timeout=self.straggler_timeout,
        )
        self.sessions.append(sess)
        # bind the job's backlog on the owning devices' ledgers (the live
        # queue-depth signal the contention model prices)
        for pid in range(job.partitions):
            self.fleet[self._owner(job, pid)].enqueue()

    def _apply_decisions(self, decisions, *, joining: Optional[str]) -> None:
        for s in self.sessions:
            d = decisions.get(s.name)
            if d is None:
                continue
            prev = s.status
            if d.status == "rejected" and s.name != joining:
                s.status, s.share = "preempted", 0
                if prev != "preempted":
                    self.events.emit(
                        "preempt", job=s.name, qos_class=s.job.qos_class,
                        by=joining,
                    )
            else:
                s.status, s.share = d.status, d.granted_units
                if d.status == "degraded":
                    out = self.outcomes[s.name]
                    if out.status == "admitted":
                        out.status = "degraded"
            if s.name == joining:
                self.events.emit(
                    "admit", job=s.name, status=d.status,
                    units=d.granted_units, qos_class=s.job.qos_class,
                )

    def _replan(self, *, trigger: str) -> None:
        """Re-run QoS-tiered allocation over the active sessions (a floor
        freed, a worker died/joined) — preempted tenants may regain shares."""
        if self.policy != "slo" or not self.sessions:
            return
        reqs = [
            SloRequest(s.name, self._demand(s.job), s.job.qos_class,
                       s.job.deadline_s)
            for s in self.sessions
        ]
        _plan, decisions = plan_pool_slo(self.capacity, reqs)
        self._apply_decisions(decisions, joining=None)
        self.events.emit(
            "plan", trigger=trigger, capacity=self.capacity,
            sessions=len(self.sessions),
        )

    # -- the claim/produce path ------------------------------------------------

    def _fallback_ok(self, sess: _SimSession, pid: int) -> bool:
        dev = sess.owner_of(pid)
        if dev not in self._manned():
            return True  # unmanned device: host fallback is the only path
        device = self.fleet[dev]
        return self.cost_model.should_offload(
            self.costs_of(sess.job, pid), device.queue_depth
        )

    def _candidates(self) -> List[_SimSession]:
        live = [s for s in self.sessions if not s.done]
        if self.policy == "fifo":
            return live  # arrival order: strict FIFO service
        return sorted(
            live, key=lambda s: (s.job.rank, self._job_index[s.name])
        )

    def _dispatch_idle(self) -> None:
        for w in sorted(self.workers, key=lambda w: w.wid):
            if w.alive and not w.busy:
                self._dispatch(w)

    def _dispatch(self, worker: _SimWorker) -> None:
        """Give one idle worker its next claim; mirrors the threaded pool's
        two passes — share-enforced first, then work-conserving."""
        if not worker.alive or worker.busy:
            return
        candidates = self._candidates()
        passes = (
            (True, False) if self.policy == "slo" else (False,)
        )
        for enforce_share in passes:
            for sess in candidates:
                if enforce_share and sess.inflight >= max(sess.share, 0):
                    continue
                if enforce_share and sess.share <= 0:
                    continue  # preempted: backfill pass only
                claimed = sess.work.claim(
                    prefer_device=worker.device,
                    fallback_ok=sess.fallback_ok,
                )
                if claimed is None:
                    continue
                self._launch(worker, sess, claimed)
                return

    def _launch(self, worker: _SimWorker, sess: _SimSession, pid: int) -> None:
        now = self.engine.now
        job = sess.job
        costs = self.costs_of(job, pid)
        owner = sess.owner_of(pid)
        local = owner == worker.device
        if local:
            route = "isp"
            start, end = self.fleet[owner].reserve(
                now, costs.isp_s, nbytes=costs.page_bytes, ops=costs.ops
            )
            self.fleet[owner].begin_claim()
        else:
            route = "host"
            sess.host_fallbacks += 1
            self.outcomes[sess.name].host_fallbacks += 1
            self.fleet[owner].shed()
            start, end = self.fleet.reserve_host(
                now, costs.host_s, link_bytes=costs.link_bytes,
                ops=costs.ops, parallelism=self.host_parallelism,
            )
        sess.inflight += 1
        worker.busy = True
        worker.task_seq += 1
        seq = worker.task_seq
        self._held[worker.wid] = (sess, pid, route, owner)
        self.events.emit(
            "claim", job=sess.name, pid=pid, wid=worker.wid, route=route,
            start=round(start, 9), end=round(end, 9),
        )
        self.engine.at(
            end, lambda: self._complete(worker, seq, sess, pid, route, owner)
        )

    def _complete(
        self,
        worker: _SimWorker,
        seq: int,
        sess: _SimSession,
        pid: int,
        route: str,
        owner: int,
    ) -> None:
        if worker.task_seq != seq:
            return  # the worker died mid-produce: the result dies with it
        self._held.pop(worker.wid, None)
        worker.busy = False
        sess.inflight -= 1
        if route == "isp":
            self.fleet[owner].end_claim()
        won = sess.work.complete(pid)
        if won:
            sess.delivered += 1
            self.fleet[owner].dequeue()
            self.events.emit(
                "complete", job=sess.name, pid=pid, wid=worker.wid,
                route=route,
            )
        if sess.done and sess.finish_s is None:
            self._finish(sess)
        self._dispatch_idle()

    def _finish(self, sess: _SimSession) -> None:
        now = self.engine.now
        sess.finish_s = now
        out = self.outcomes[sess.name]
        out.finish_s = now
        out.reissues = sess.work.reissues
        self.sessions.remove(sess)
        self.events.emit(
            "job_done", job=sess.name, qos_class=sess.job.qos_class,
            latency_s=round(now - out.arrival_s, 9),
            slo_met=out.slo_met, reissues=out.reissues,
        )
        self._replan(trigger="job_done")

    # -- reports ---------------------------------------------------------------

    def report(self, *, starvation_factor: float = 10.0) -> SimReport:
        makespan = max(
            (o.finish_s for o in self.outcomes.values() if o.finish_s is not None),
            default=0.0,
        )
        return SimReport(
            policy=self.policy,
            seed=self.engine.seed,
            outcomes=[
                self.outcomes[k] for k in sorted(self.outcomes)
            ],
            makespan_s=makespan,
            events_processed=self.engine.processed,
            device_utilization=self.fleet.utilization(),
            host_busy_s=self.fleet.host_busy_s,
            starvation_factor=starvation_factor,
        )

    def trace_bytes(self) -> bytes:
        """The run's full event trace, canonically serialized — two runs of
        the same seeded schedule must produce EQUAL bytes."""
        return json.dumps(
            self.events.to_dicts(), sort_keys=True, separators=(",", ":")
        ).encode()


class SimHarness:
    """Seeded, replayable virtual-time scenario runner (the test fixture).

    Build a harness, submit jobs (or a ``zipf_sessions`` workload), schedule
    chaos (``kill_at``/``join_at``), ``run()`` — everything happens in
    virtual time, and ``trace_bytes()`` is a pure function of the seed and
    the schedule: replaying the same seed MUST produce equal bytes.
    """

    def __init__(self, seed: int = 0, **service_kwargs: Any):
        self.engine = SimEngine(seed=seed)
        self.service = SimService(self.engine, **service_kwargs)

    def submit(self, *jobs: SimJob) -> "SimHarness":
        for j in jobs:
            self.service.submit(j)
        return self

    def workload(self, n: int, **kwargs: Any) -> List[SimJob]:
        jobs = zipf_sessions(n, rng=self.engine.rng, **kwargs)
        self.service.submit_all(jobs)
        return jobs

    def kill_at(self, t: float, wid: int) -> "SimHarness":
        self.engine.at(t, lambda: self.service.kill_worker(wid))
        return self

    def join_at(self, t: float, device: Optional[int] = None) -> "SimHarness":
        self.service.join_worker_at(t, device)
        return self

    def run(self, until: Optional[float] = None) -> SimReport:
        self.engine.run(until)
        return self.service.report()

    def trace_bytes(self) -> bytes:
        return self.service.trace_bytes()
