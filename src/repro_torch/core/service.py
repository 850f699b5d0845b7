"""Preprocessing-as-a-service: a shared worker/ISP pool serving many jobs.

The port's own copy of ``repro.core.service``, over ``TorchPreStoEngine``.
What differs from the reference is only what the card forces:

* A chunk is dispatched through the engine's one dispatch pair:
  ``TorchPreStoEngine.launch`` copies the chunk's pinned pages in and
  queues its kernels on the device's current stream without blocking, and
  ``deliver`` waits on the chunk's CUDA event.  A solo claim goes through
  as a stacked K = 1 chunk; nothing is compiled, so there is no solo
  executable and no executable registry.
* A chunk's pages are stacked into one pinned buffer when the chunk is
  staged (``_stage_chunk``; the lookahead's ``_prestage`` keeps numpy
  pages until then), so the copy-in at dispatch is asynchronous and
  overlaps the in-flight chunk.
* The pool worker waits on the chunk's event, outside every lock, before
  it completes any future: a batch is complete on the device before a
  consumer on another thread can see it.  On the CPU there is no event.
* Worker threads keep all work on the device's current stream; every
  dispatch selects the engine's device.  The engine is one device and has
  no mesh.
* ``JobSpec.device`` (None = CUDA) places the engine a job builds; an
  engine passed in keeps its own device.

The paper's deployment end-game — and the disaggregated-DPP model of Meta's
production ingestion stack — is preprocessing as a *service*: one provisioned
fleet of ISP units shared across training jobs, with per-job admission and
unit allocation, instead of a private worker pool hand-wired into each
trainer.  This module is that public surface:

    service = PreprocessingService(num_workers=8)
    session = service.submit(JobSpec(
        name="rm1", spec=spec, store=store, partitions=range(64),
        placement="presto", target_samples_per_s=50_000))
    for pid, minibatch in session:          # backpressured stream
        state, metrics = train_step(state, minibatch)

* ``JobSpec`` — what a train manager hands the service at job launch: the
  RecSys Transform (a ``TransformSpec`` or a prebuilt
  ``TorchPreStoEngine``), the partition range, placement mode, and QoS
  target (samples/s).
* ``Session`` — a backpressured streaming iterator of mini-batch futures in
  claim order (``futures()`` for the raw future stream; iterating resolves
  them to ``(pid, minibatch)``), with ``stats()``, ``cancel()``, and
  ``drain()``.
* ``PreprocessingService`` — owns the one worker pool.  Admission control
  and per-job unit shares come from ``core.planner.plan_pool`` (ceil(T/P)
  demand per job, re-planned whenever jobs join, leave, or re-estimate their
  per-worker throughput P); pool workers feed every session's
  ``data.loader.SessionQueue``.  Shares are work-conserving: idle capacity
  may serve any job beyond its share, but a job with work never gets less
  than its share.
* The service may own ONE shared ``core.featcache.FeatureCache``
  (``PreprocessingService(cache=FeatureCache(...))``): every cacheable
  session probes it at claim time (a hit short-circuits the claim — no
  produce, same bitwise batch) and populates it on produce, so concurrent
  tenants over overlapping partitions deduplicate work; a job's planner
  demand is discounted by its observed hit rate, freeing units for cold
  jobs.  Jobs opt out per-``JobSpec`` (``use_cache=False``); produce_fn
  overrides are never cached (opaque identity).
* With ``PreprocessingService(devices=DeviceFleet(...))`` the pool's units
  are bound to the simulated storage devices and scheduling becomes
  device-aware: claims prefer the ISP unit of the partition's OWNING device
  and fall back to host placement only when the owning device's live queue
  prices the ISP path past the host path (contention-aware cost model).
  Routing never changes batch bytes — only where/when they are produced —
  so every bitwise-identity guarantee above survives skewed placements.
* The pool is ELASTIC (``core.ctrlplane``): workers can be killed
  (crash-simulated — their in-flight claims are force-expired and re-issued
  through the existing straggler path, so the consumer stream stays bitwise
  identical to a no-failure run), gracefully retired, or added at runtime
  (``kill_worker`` / ``remove_worker`` / ``add_worker``); device bindings
  and pool shares re-plan on every membership change.  Sessions snapshot
  their progress frontier (``Session.checkpoint``, periodic via
  ``JobSpec.checkpoint_path``) so a restarted service resumes a
  half-drained job (``submit(job, resume_from=ckpt)``) bitwise-identically;
  an ``Autoscaler`` policy loop may grow/shrink the pool from
  ``load_snapshot()`` backlog.  Every membership change, claim re-issue,
  checkpoint, scale decision, and plan change is published to the service's
  bounded ``EventLog`` (``service.events``, surfaced in ``stats()``).
* The produce hot path is ZERO-STALL by default (``pipeline=True``):
  engine-backed sessions are *stageable* — a pool worker coalesces up to
  ``JobSpec.megabatch`` compatible claims into ONE megabatched kernel
  launch (one ``TorchPreStoEngine.launch``), dispatches it asynchronously,
  and stages the NEXT chunk's partition reads, page-builds and pins while
  the kernels execute, waiting on the chunk's CUDA event only at
  delivery.  Modeled I/O, host staging, and kernel execution overlap;
  ledgers are still charged per partition to the right owners, and every
  delivered batch stays bitwise identical to its solo serial run.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from queue import Empty
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import torch

from repro_torch.core.autotune import DEFAULT_AUTOTUNE_KMAX, MegabatchTuner
from repro_torch.core.costmodel import ContentionAwareCostModel, PartitionCosts
from repro_torch.core.ctrlplane import EventLog, SessionCheckpoint, SessionError
from repro_torch.core.featcache import BlockKey, CacheKey, FeatureCache
from repro_torch.core.planner import (
    QOS_EXPLORATORY,
    AdmissionError,
    DeviceTopology,
    PoolPlan,
    SloRequest,
    effective_demand_units,
    plan_pool,
    plan_pool_slo,
    qos_demand_units,
)
from repro_torch.core.preprocess import stack_pages
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.loader import SessionQueue
from repro_torch.data.storage import (
    DeviceFleet,
    DeviceOfflineError,
    IoFaultError,
    IspDevice,
    PartitionedStore,
)

__all__ = [
    "AdmissionError",
    "DeviceFleet",
    "EventLog",
    "FeatureCache",
    "JobSpec",
    "PreprocessingService",
    "Session",
    "SessionCheckpoint",
    "SessionError",
    "SessionStats",
]

MAX_DEMAND_UNITS = 64  # sanity cap on a single job's ceil(T/P) estimate
# default byte budget for pages staged AHEAD of their claims (per session);
# deep-lookahead pre-staging stops, never stalls, when the budget is full
DEFAULT_STAGE_BUDGET_BYTES = 256 << 20


@dataclasses.dataclass
class JobSpec:
    """One training job's preprocessing contract with the service."""

    name: str
    partitions: Iterable[int]
    spec: Optional[TransformSpec] = None
    store: Optional[PartitionedStore] = None
    placement: Union[str, Dict[str, str]] = "presto"
    target_samples_per_s: Optional[float] = None  # QoS; None = best effort
    # -- SLO contract ---------------------------------------------------------
    # qos_class: admission priority tier (core.planner.QOS_*).  Under SLO-
    # aware admission, release-candidate ("rc") jobs take surplus units
    # before — and may preempt the floors of — exploratory jobs.
    qos_class: str = QOS_EXPLORATORY
    # deadline_s: completion SLO relative to submission/arrival.  Advisory
    # on the wall-clock path (surfaced through stats); the virtual-time
    # simulator (core.simclock) scores per-class SLO attainment against it.
    deadline_s: Optional[float] = None
    units: Optional[int] = None  # explicit demand override (else T/P estimate)
    queue_depth: int = 4
    straggler_timeout: float = 30.0
    engine: Optional[TorchPreStoEngine] = None  # prebuilt (keeps its own device)
    produce_fn: Optional[Callable[[int], Any]] = None  # override / test hook
    use_cache: bool = True  # opt out of the service's shared feature cache
    # megabatching: a pool worker may coalesce up to this many compatible
    # claims of this session into ONE megabatched kernel launch (amortized
    # dispatch; bitwise identical to solo launches).  Engine-backed sessions
    # only — produce_fn overrides are opaque and never coalesce.
    megabatch: int = 1
    # -- self-tuning produce path ---------------------------------------------
    # autotune: hill-climb megabatch K online from measured launches
    # (core.autotune.MegabatchTuner, seeded from the cost model's predicted
    # optimum).  ``megabatch`` then acts as the K CAP; left at 1 the tuner
    # climbs up to DEFAULT_AUTOTUNE_KMAX.
    autotune: bool = False
    # lookahead: how many chunks of partition reads + page-builds may be
    # staged beyond the in-flight kernel.  1 is the classic double buffer
    # (stage exactly the next chunk); deeper windows pre-stage FUTURE claims
    # from the queue's non-claiming peek window, budget permitting.
    lookahead: int = 1
    # byte budget for pages staged AHEAD of their claims (None = the
    # service default, 0 disables pre-staging).  Accounted in deterministic
    # page-geometry bytes — the same bytes the owning device's ledger is
    # charged when the read actually happens.
    stage_budget_bytes: Optional[int] = None
    # prewarm: walk the peek window and issue FeatureCache.begin() leases
    # ahead of the claim cursor — spill-tier entries get promoted before the
    # worker arrives, and cold keys take the leader lease early so
    # concurrent tenants follow instead of duplicating the produce.
    prewarm: bool = True
    # -- control plane --------------------------------------------------------
    # checkpoint_path: where the session periodically snapshots its progress
    # frontier (core.ctrlplane.SessionCheckpoint JSON) — every
    # ``checkpoint_every`` deliveries and at completion.  A restarted
    # service resumes the job bitwise-identically via
    # ``service.submit(job, resume_from=SessionCheckpoint.load(path))``.
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 8
    # -- storage fault domain --------------------------------------------------
    # io_retries: how many times one partition's claim may be re-issued after
    # a RETRYABLE I/O fault (transient read error, torn/bit-flipped block,
    # device knocked offline) before the partition is quarantined and the
    # session surfaces a structured ``SessionError`` through its future.
    # io_backoff_s: base delay before the n-th retry (exponential:
    # ``io_backoff_s * 2**(n-1)``), served by the queue's clock — real time
    # by default, virtual when the session runs under ``core.simclock``.
    io_retries: int = 3
    io_backoff_s: float = 0.01
    # the device of the engine this job builds from ``spec`` (None = CUDA,
    # raising when no card is present); an ``engine`` passed in keeps its own
    device: Optional[Union[str, torch.device]] = None

    def build_produce(self) -> Tuple[Callable[[int], Any], Optional[TorchPreStoEngine]]:
        """Resolve the per-partition production callable for this job."""
        if self.produce_fn is not None:
            return self.produce_fn, self.engine
        engine = self.engine
        if engine is None:
            if self.spec is None:
                raise ValueError(
                    f"JobSpec {self.name!r} needs a spec, an engine, or a produce_fn"
                )
            engine = TorchPreStoEngine(
                self.spec, placement=self.placement, device=self.device
            )
        if self.store is None:
            raise ValueError(f"JobSpec {self.name!r} needs a store")
        store = self.store
        return (lambda pid: engine.produce_batch(store, pid)), engine

    def cache_key_fn(
        self, engine: Optional[TorchPreStoEngine]
    ) -> Optional[Callable[[int], CacheKey]]:
        """Content-address builder for this job's batches, or None when the
        job is not cacheable (produce_fn overrides are opaque; no store means
        no partition fingerprints)."""
        if (
            not self.use_cache
            or self.produce_fn is not None
            or engine is None
            or self.store is None
        ):
            return None
        store, plan_hash = self.store, engine.cache_signature()
        placement = engine.placement

        def key(pid: int) -> CacheKey:
            return CacheKey(store.partition_fingerprint(pid), plan_hash, placement)

        return key


@dataclasses.dataclass
class SessionStats:
    """Point-in-time accounting for one session (paper Fig. 3 metrics)."""

    job: str
    total: int
    produced: int = 0  # winner completions by pool workers
    delivered: int = 0  # batches handed to the consumer
    reissues: int = 0  # straggler backup claims
    duplicates_dropped: int = 0  # straggler losers discarded
    cache_hits: int = 0  # claims short-circuited by the shared feature cache
    cache_misses: int = 0  # cache probes that fell through to a produce
    # block-granularity dedup (RecD): claims whose batch was ASSEMBLED from
    # cached shared sparse blocks (subset of cache_hits), and unique blocks
    # this session published after cold produces
    block_hits: int = 0
    blocks_published: int = 0
    effective_demand_units: int = 1  # demand after the hit-rate discount
    rows_delivered: int = 0
    produce_time_s: float = 0.0  # pool-worker seconds spent on this job
    # two parts of produce_time_s, counted on the pool workers, which a
    # profiler enabled on the consumer's thread does not see: the chunks'
    # staging (read, page build, pin) and the workers' wait in
    # ``engine.deliver`` (the Transform queued behind other device work)
    stage_time_s: float = 0.0
    deliver_wait_s: float = 0.0
    wait_time_s: float = 0.0  # consumer seconds blocked on the stream
    wall_time_s: float = 0.0
    demand_units: int = 1
    share: int = 0
    target_samples_per_s: Optional[float] = None
    worker_samples_per_s: float = 0.0  # measured per-worker P
    cancelled: bool = False
    done: bool = False
    host_fallbacks: int = 0  # fresh claims routed off their owning device
    # -- storage fault domain observability --
    retries: int = 0  # claims re-issued after a retryable I/O fault
    failovers: int = 0  # claims re-routed off an offline device's replica path
    quarantined: int = 0  # partitions that exhausted their retry budget
    # device -> winner produces that ran ON that device (ISP route); the
    # skew surface: a hot device's count dwarfs the cold ones' under Zipf
    device_produced: Dict[int, int] = dataclasses.field(default_factory=dict)
    # -- self-tuning produce path observability --
    tuned_k: int = 1  # megabatch K currently in effect (autotuned or static)
    staged_bytes_peak: int = 0  # peak bytes pre-staged ahead of claims
    prewarm_hits: int = 0  # peek-window pre-warm probes that found content cached
    # -- SLO contract observability --
    qos_class: str = QOS_EXPLORATORY
    slo_status: str = "admitted"  # admitted / degraded / preempted
    deadline_s: Optional[float] = None  # completion SLO relative to submit

    @property
    def achieved_samples_per_s(self) -> float:
        return self.rows_delivered / max(self.wall_time_s, 1e-9)

    @property
    def starvation(self) -> float:
        """Fraction of the session's wall time the consumer spent blocked."""
        return self.wait_time_s / max(self.wall_time_s, 1e-9)

    @property
    def cache_hit_rate(self) -> float:
        probes = self.cache_hits + self.cache_misses
        return self.cache_hits / probes if probes else 0.0


def _batch_rows(batch: Any) -> int:
    try:
        return int(batch["labels"].shape[0])
    except Exception:
        return 0


@dataclasses.dataclass
class _Chunk:
    """Up to K coalesced claims of one session, staged for one launch.

    The unit the zero-stall worker loop moves through its pipeline: claims
    are coalesced and their pages staged and pinned (reads charged
    per-partition to the OWNING devices), the launch is dispatched
    asynchronously, the next chunk's staging overlaps the in-flight
    kernels, and the host waits on the chunk's CUDA event only at delivery.
    """

    session: "Session"
    claims: List[Tuple[int, Future, Optional[str]]]
    # staged pinned pages, stacked along a leading K axis (K = 1 included);
    # None = opaque produce_fn
    pages: Optional[Any]
    stage_s: float = 0.0  # read + page-build seconds (production cost)
    devs: List[Optional[IspDevice]] = dataclasses.field(default_factory=list)
    t0: float = 0.0  # dispatch instant


class Session:
    """One job's handle on the service: a backpressured mini-batch stream.

    Single-consumer: iterate the session (or its ``futures()``) from one
    thread.  Iteration yields ``(pid, minibatch)`` in claim order, ends after
    every partition is delivered, and re-raises a worker's production error.
    """

    def __init__(
        self,
        service: "PreprocessingService",
        job: JobSpec,
        resume_from: Optional[SessionCheckpoint] = None,
    ):
        self._service = service
        self.job = job
        self.name = job.name
        # latest SLO admission decision for this session ("admitted" /
        # "degraded" / "rejected"-i.e.-preempted); only the SLO admission
        # policy ever moves it off the default
        self.slo_status = "admitted"
        self._produce_fn, self.engine = job.build_produce()
        # materialize the dedup'd partition order ONCE (job.partitions may
        # be a one-shot iterable): the queue, the device-backlog binding,
        # and checkpoints all read this same list
        self._partitions: List[int] = list(dict.fromkeys(job.partitions))
        # -- zero-stall produce path eligibility --------------------------------
        # Stageable sessions run the pipelined worker path: reads/page-builds
        # are separable from the kernel launch, so workers can megabatch K
        # claims into one launch and overlap the next chunk's staging with
        # the in-flight kernel.  produce_fn overrides are opaque (no
        # separable stage).
        self._stageable = (
            service.pipeline
            and job.produce_fn is None
            and job.store is not None
            and self.engine is not None
        )
        # coalescing additionally needs every lowered stage row-local —
        # plans with a cross-row operator degrade gracefully to solo
        # launches (still staged/overlapped) instead of failing claims
        self._megabatch_k = (
            max(1, int(job.megabatch))
            if self._stageable and self.engine.lowered_plan.megabatch_safe()
            else 1
        )
        # -- online megabatch-K autotuning ---------------------------------
        # One tuner per autotuned session, seeded from the cost model's
        # predicted amortization knee; every finished launch feeds its
        # overlap-corrected seconds back (``_finish_chunk``) and a K move
        # re-bases the planner's P estimate (``_on_tuned_k_changed``).
        self._tuner: Optional[MegabatchTuner] = None
        self._rows_hint = 0
        if self._stageable:
            self._rows_hint = int(
                getattr(job.store.source, "rows", None)
                or self.engine.spec.cfg.rows_per_partition
            )
        if (
            job.autotune
            and self._stageable
            and self.engine.lowered_plan.megabatch_safe()
        ):
            k_cap = (
                int(job.megabatch) if job.megabatch > 1 else DEFAULT_AUTOTUNE_KMAX
            )
            try:
                per_part = self.engine.route_costs(
                    rows=self._rows_hint or None, model=service.cost_model
                ).isp_s
            except Exception:
                per_part = None  # unseedable: the tuner starts at K=1
            self._tuner = MegabatchTuner(
                k_cap, per_partition_s=per_part, cost_model=service.cost_model
            )
            if resume_from is not None and resume_from.tuner:
                # resume: re-seed at the checkpointed rung (measured EMAs
                # and convergence carry over) instead of re-climbing
                self._tuner.restore(resume_from.tuner)
        # -- deep lookahead + cache pre-warm state -------------------------
        self._lookahead = max(1, int(job.lookahead))
        self._stage_budget = (
            DEFAULT_STAGE_BUDGET_BYTES
            if job.stage_budget_bytes is None
            else max(0, int(job.stage_budget_bytes))
        )
        # pages staged AHEAD of their claims: pid -> (pages, charged_bytes,
        # stage seconds).  Charged in deterministic page-geometry bytes
        # (``_page_nbytes``) so the budget check can run BEFORE the read.
        self._prestaged: Dict[int, Tuple[Any, int, float]] = {}
        self._staging_now: set = set()
        self._staged_bytes = 0
        self._staged_bytes_peak = 0
        self._page_nbytes = 0
        if self._stageable and self._rows_hint:
            # sized from the torch dtypes' item sizes: the same bytes as the
            # reference's uint32 pages, so the budget admits the same pages
            structs = self.engine.pages_struct(self._rows_hint)
            self._page_nbytes = int(
                sum(math.prod(s.shape) * s.dtype.itemsize for s in structs.values())
            )
        # cache pre-warm: pids probed ahead of the cursor (once each), the
        # leader leases we hold for them, and how many were already cached
        self._prewarmed: set = set()
        self._prewarm_cached: set = set()
        self._prewarm_leases: Dict[int, CacheKey] = {}
        self._prewarm_hits = 0
        self._cache = service.cache if job.use_cache else None
        self._cache_key = (
            job.cache_key_fn(self.engine) if self._cache is not None else None
        )
        # block-granularity dedup (RecD): cacheable, store-bound jobs
        # publish each cold produce's unique hashed sparse blocks and
        # assemble full-coverage misses from other tenants' blocks
        self._block_key_parts: Optional[Tuple[str, str]] = None
        if (
            self._cache_key is not None
            and self.engine is not None
            and job.store is not None
        ):
            self._block_key_parts = (
                self.engine.cache_signature(),
                self.engine.placement,
            )
        self._block_hits = 0
        self._blocks_published = 0
        # -- device routing (fleet-backed services with a store-bound job) --
        self._fleet = service.fleet
        self._owner_of: Optional[Callable[[int], int]] = None
        self._costs: Optional[PartitionCosts] = None
        if self._fleet is not None and job.store is not None:
            store, ndev = job.store, len(self._fleet)
            self._owner_of = lambda pid: store.owner_of(pid) % ndev
            if self.engine is not None:
                # price the partitions the store ACTUALLY serves: a sourced
                # store's row count overrides the spec's default geometry
                rows = getattr(store.source, "rows", None)
                self._costs = self.engine.route_costs(
                    rows=rows, model=service.cost_model
                )
        self._queue = SessionQueue(
            self._partitions,
            depth=job.queue_depth,
            straggler_timeout=job.straggler_timeout,
            lookup=self._cache_probe if self._cache_key is not None else None,
            owner_of=self._owner_of,
            fallback_ok=self._host_ok if self._owner_of is not None else None,
            on_settled=self._release_backlog if self._owner_of is not None else None,
            on_offload=self._on_offload if self._owner_of is not None else None,
            on_reissue=self._on_reissue,
        )
        self.total = self._queue.total
        # guarded by service._lock:
        self.share = 0
        self._active_workers = 0
        self._active_by_dev: Dict[int, int] = {}  # worker device -> active
        self._demand = max(1, job.units or 1)
        # guarded by self._slock:
        self._slock = threading.Lock()
        self._produced = 0
        self._handed = 0  # futures taken off the delivery queue (any stream)
        self._delivered = 0
        self._delivered_pids: List[int] = []  # the checkpoint frontier
        self._duplicates = 0
        self._rows_delivered = 0
        self._produce_time = 0.0
        self._stage_time = 0.0
        self._deliver_wait = 0.0
        self._wait_time = 0.0
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_keys: Dict[int, CacheKey] = {}  # pid -> key, probe->produce
        # storage fault domain: per-partition retry attempts plus the
        # session-level counters stats() surfaces
        self._fault_attempts: Dict[int, int] = {}
        self._retries = 0
        self._failovers = 0
        self._quarantined = 0
        self._eff_demand = self._demand  # last hit-rate-discounted demand
        self._p_est: Optional[float] = None
        self._device_produced: Dict[int, int] = {}  # ISP-route winner counts
        # device backlog: every partition is bound to its owning device until
        # it completes or is offloaded to the host — the live queue_depth the
        # contention-aware router reads.  _backlogged makes release idempotent
        # (a pid can be both offloaded and later completed).
        self._backlogged: set = set()
        self.device_weights: Optional[Dict[int, float]] = None
        if self._owner_of is not None:
            pids = self._queue.work.pending_snapshot()  # pre-start snapshot
            counts: Dict[int, int] = {}
            for pid in pids:
                counts[self._owner_of(pid)] = counts.get(self._owner_of(pid), 0) + 1
            if pids:
                self.device_weights = {
                    d: c / len(pids) for d, c in counts.items()
                }
            self._backlogged = set(pids)
            for d, c in counts.items():
                self._fleet[d].enqueue(c)
        # a fault-injected store publishes io_fault/device_offline events
        # through the service's stream (duck-typed: data/ never imports core/)
        inj = getattr(job.store, "fault_injector", None) if job.store else None
        if inj is not None and getattr(inj, "events", None) is None:
            inj.events = service.events
        self._t0 = time.perf_counter()
        self._t_end: Optional[float] = None

    # -- consumer side ---------------------------------------------------------

    @property
    def cancelled(self) -> bool:
        return self._queue.cancelled.is_set()

    @property
    def done(self) -> bool:
        """Every partition delivered to the consumer."""
        with self._slock:
            return self._delivered >= self.total

    def _next_future(self) -> Optional[Future]:
        """Take the next undelivered future off the stream (None = stream end).

        The hand-off count is session state, not per-iterator, so a partially
        consumed session can be re-iterated (or ``drain()``-ed) and resumes
        where the previous loop stopped.
        """
        while not self.cancelled:
            with self._slock:
                if self._handed >= self.total:
                    return None
            try:
                fut = self._queue.out.get(timeout=0.25)
            except Empty:
                self._check_liveness()
                continue
            with self._slock:
                self._handed += 1
            return fut
        return None

    def futures(self) -> Iterator[Future]:
        """The raw stream: mini-batch futures in claim order.

        Taking a future transfers ownership: it counts as delivered for
        backpressure, so pacing beyond ``queue_depth`` outstanding claims is
        the raw consumer's responsibility.  Delivery stats (and ``done``)
        are recorded when each future resolves.  Shares the delivery queue
        with plain iteration — use one stream or the other.
        """
        while True:
            fut = self._next_future()
            if fut is None:
                return
            self._queue.mark_delivered()
            self._service._wake()
            fut.add_done_callback(self._account_delivery)
            yield fut

    def _account_delivery(self, fut: Future) -> None:
        """Delivery accounting for the raw-future stream (on resolution)."""
        if fut.cancelled() or fut.exception() is not None:
            return
        _pid, batch = fut.result()
        with self._slock:
            self._delivered += 1
            self._delivered_pids.append(_pid)
            self._rows_delivered += _batch_rows(batch)
            if self._delivered >= self.total:
                self._t_end = time.perf_counter()
        self._maybe_checkpoint()

    def __iter__(self) -> Iterator[Tuple[int, Any]]:
        while True:
            t0 = time.perf_counter()
            fut = self._next_future()
            if fut is None:
                return
            while True:
                if self.cancelled:
                    return
                try:
                    pid, batch = fut.result(timeout=0.25)
                    break
                except FutureTimeoutError:
                    self._check_liveness()
            # pacing signal only once the batch is resolved and in the
            # consumer's hands: at most queue_depth batches sit materialized
            self._queue.mark_delivered()
            self._service._wake()
            with self._slock:
                self._wait_time += time.perf_counter() - t0
                self._delivered += 1
                self._delivered_pids.append(pid)
                self._rows_delivered += _batch_rows(batch)
                if self._delivered >= self.total:
                    self._t_end = time.perf_counter()
            self._maybe_checkpoint()
            yield pid, batch

    def drain(self) -> int:
        """Consume and discard the rest of the stream; returns batches eaten.

        After ``cancel()`` this returns immediately; otherwise it blocks
        until the job's remaining partitions are produced (an end-of-job
        barrier that keeps pool accounting exact)."""
        n = 0
        for _ in self:
            n += 1
        return n

    def cancel(self) -> None:
        """Stop the stream: pool workers stop claiming for this session,
        undelivered results are discarded, and the pool is rebalanced."""
        if self.cancelled:
            return
        self._queue.cancel()
        with self._slock:
            if self._t_end is None:
                self._t_end = time.perf_counter()
        self._service._retire(self)

    def stats(self) -> SessionStats:
        with self._slock:
            wall = (self._t_end or time.perf_counter()) - self._t0
            return SessionStats(
                job=self.name,
                total=self.total,
                produced=self._produced,
                delivered=self._delivered,
                reissues=self._queue.work.reissues,
                duplicates_dropped=self._duplicates,
                rows_delivered=self._rows_delivered,
                produce_time_s=self._produce_time,
                stage_time_s=self._stage_time,
                deliver_wait_s=self._deliver_wait,
                wait_time_s=self._wait_time,
                wall_time_s=wall,
                demand_units=self._demand,
                cache_hits=self._cache_hits,
                cache_misses=self._cache_misses,
                block_hits=self._block_hits,
                blocks_published=self._blocks_published,
                effective_demand_units=effective_demand_units(
                    self._demand, self._hit_rate_locked()
                ),
                share=self.share,
                target_samples_per_s=self.job.target_samples_per_s,
                worker_samples_per_s=self._p_est or 0.0,
                cancelled=self.cancelled,
                done=self._delivered >= self.total,
                host_fallbacks=self._queue.host_fallbacks,
                retries=self._retries,
                failovers=self._failovers,
                quarantined=self._quarantined,
                device_produced=dict(self._device_produced),
                tuned_k=(
                    self._tuner.k if self._tuner is not None else self._megabatch_k
                ),
                staged_bytes_peak=self._staged_bytes_peak,
                prewarm_hits=self._prewarm_hits,
                qos_class=self.job.qos_class,
                slo_status=self.slo_status,
                deadline_s=self.job.deadline_s,
            )

    def _check_liveness(self) -> None:
        if self._service.closed:
            with self._slock:
                undelivered = self.total - self._delivered
            raise RuntimeError(
                f"preprocessing service closed with {undelivered} batches "
                f"undelivered for job {self.name!r}"
            )

    # -- control plane: checkpoint/resume + crash cleanup ----------------------

    def checkpoint(self) -> SessionCheckpoint:
        """Snapshot this session's progress frontier for restart/resume.

        The frontier is the DELIVERED pid set: produced-but-undelivered
        batches die with the service (their futures are service state), so
        resume must re-produce them — which is free of risk because
        partitions are deterministic.  Safe to call at any time, from any
        thread."""
        with self._slock:
            delivered = list(self._delivered_pids)
            stats = {
                "produced": self._produced,
                "delivered": self._delivered,
                "reissues": self._queue.work.reissues,
                "duplicates_dropped": self._duplicates,
                "cache_hits": self._cache_hits,
                "cache_misses": self._cache_misses,
                "rows_delivered": self._rows_delivered,
            }
        return SessionCheckpoint(
            job=self.name,
            partitions=list(self._partitions),
            delivered=delivered,
            stats=stats,
            tuner=self._tuner.summary() if self._tuner is not None else None,
        )

    def _maybe_checkpoint(self) -> None:
        """Periodic frontier snapshot (``JobSpec.checkpoint_path``): every
        ``checkpoint_every`` deliveries and at completion.  An unwritable
        path degrades to no checkpoint — it never breaks delivery."""
        path = self.job.checkpoint_path
        if not path:
            return
        with self._slock:
            n = self._delivered
        if n % max(1, int(self.job.checkpoint_every)) and n < self.total:
            return
        try:
            self.checkpoint().save(path)
        except Exception:
            return
        self._service.events.emit(
            "checkpoint", job=self.name, delivered=n, total=self.total, path=path
        )

    def _on_reissue(self, pid: int) -> None:
        """WorkQueue straggler-re-issue observer -> the event stream."""
        self._service.events.emit("claim_reissue", job=self.name, pid=pid)

    def _expire_claims(self, pids: Iterable[int]) -> None:
        """Force-expire claims a dead worker held so the next claim round
        re-issues them immediately through the straggler path."""
        for pid in pids:
            self._queue.expire(pid)
        self._service._wake()

    def _abandon_chunk(self, chunk: "_Chunk") -> None:
        """Crash cleanup for a chunk a killed worker held (staged or even
        dispatched — never finished): any results in hand die with the
        worker.  Leader cache leases are abandoned so cross-tenant followers
        re-issue real produces instead of waiting forever, ISP device
        occupancy is released, and every claim is expired back through the
        straggler path.  The claims' futures stay pending — the re-issued
        produce resolves them, so the consumer stream (and every delivered
        byte) is untouched by the crash."""
        for pid, _f, _r in chunk.claims:
            if self._cache_key is not None:
                with self._slock:
                    key = self._cache_keys.pop(pid, None)
                if key is not None:
                    try:
                        self._cache.abandon(key)
                    except Exception:
                        pass
        for dev in chunk.devs:
            self._route_end(dev)
        chunk.devs = []
        self._expire_claims(pid for pid, _f, _r in chunk.claims)

    # -- device routing --------------------------------------------------------

    def _host_ok(self, pid: int) -> bool:
        """Fallback eligibility for a foreign claim of `pid`: its owning
        device has no bound unit at all, or the contention-aware cost model
        says the live queue has priced the ISP path past the host path.
        The candidate itself is still in the device's backlog, so the wait
        it would experience is behind the OTHER queued claims."""
        owner = self._owner_of(pid)
        if getattr(self._fleet[owner], "offline", False):
            return True  # an offline device computes nothing: host is the
            # only route (reads go through the replica/failover path)
        if owner not in self._service._manned:
            return True
        return self._service.cost_model.should_offload(
            self._costs, self._fleet[owner].queue_depth - 1
        )

    def _release_backlog(self, pid: int) -> None:
        """`pid` stopped waiting on its owning device (completed, errored,
        served by the cache, or offloaded to the host).  Idempotent."""
        with self._slock:
            present = pid in self._backlogged
            self._backlogged.discard(pid)
        if present:
            self._fleet[self._owner_of(pid)].dequeue()

    def _on_offload(self, pid: int) -> None:
        """A fresh claim of `pid` was routed to the host: the owning device
        stops waiting on it and records the shed."""
        self._fleet[self._owner_of(pid)].shed()
        self._release_backlog(pid)

    def _release_all_backlog(self) -> None:
        with self._slock:
            pids = list(self._backlogged)
            self._backlogged.clear()
        for pid in pids:
            self._fleet[self._owner_of(pid)].dequeue()

    def _route_begin(self, pid: int, route: Optional[str]) -> Optional[IspDevice]:
        """An ISP-routed produce occupies the owning device for its duration
        (the in-flight ceiling ``tests/test_devices.py`` pins)."""
        if route == "isp" and self._owner_of is not None:
            dev = self._fleet[self._owner_of(pid)]
            dev.begin_claim()
            return dev
        return None

    @staticmethod
    def _route_end(dev: Optional[IspDevice]) -> None:
        if dev is not None:
            dev.end_claim()

    # -- pool-worker side: the zero-stall chunk pipeline -----------------------

    def _current_k(self) -> int:
        """Megabatch width for the next launch: the tuner's live proposal
        when autotuning, else the static ``JobSpec.megabatch``."""
        if self._tuner is not None:
            return self._tuner.k
        return self._megabatch_k

    def _stage_chunk(
        self, claim: Tuple[int, Future, Optional[str]], prefer: Optional[int]
    ) -> Optional["_Chunk"]:
        """Coalesce up to K compatible claims and stage their pages.

        Coalesced claims ride the one worker slot the scheduler already
        reserved (a megabatch is ONE launch occupying one unit); per-device
        plan slices bound the first claim, the ride-alongs are bounded by
        the session's own queue depth.  Every partition read is charged to
        its owning device inside ``store.read``.  Partitions the lookahead
        walker already pre-staged are consumed from the staging buffer
        (their read time was paid — and recorded — during a previous
        chunk's kernel); the rest are read and page-built here.  The K
        partitions' pages are stacked into one pinned buffer, so the
        copy-in at dispatch never blocks.  Returns None when staging
        fails — the claims' futures carry the error (deterministic in pid,
        so straggler twins would fail identically).
        """
        claims = [claim]
        for _ in range(self._current_k() - 1):
            extra = self._queue.claim(prefer_device=prefer)
            if extra is None:
                break
            claims.append(extra)
        if not self._stageable:
            return _Chunk(self, claims, None)
        t0 = time.perf_counter()
        pre_s = 0.0  # stage seconds already paid by the lookahead walker
        per: List[Any] = []
        kept: List[Tuple[int, Future, Optional[str]]] = []
        try:
            for pid, f, r in claims:
                entry = self._take_prestaged(pid)
                if entry is not None:
                    pages_i, _nb, s = entry
                    pre_s += s
                else:
                    try:
                        pages_i = self.engine.stage_partition(
                            self.job.store, pid
                        )
                    except IoFaultError as exc:
                        # a faulted read condemns ONLY its own claim (the
                        # retry/quarantine policy decides its fate) — its
                        # chunk mates stage on with their own budgets intact
                        self._on_produce_error(pid, exc)
                        continue
                per.append(pages_i)
                kept.append((pid, f, r))
            if not kept:
                return None
            pages = self.engine.pin_pages(stack_pages(per))
        except BaseException as exc:  # noqa: BLE001 — consumer re-raises
            for pid, _f, _r in kept or claims:
                self._on_produce_error(pid, exc)
            return None
        return _Chunk(
            self, kept, pages, stage_s=time.perf_counter() - t0 + pre_s
        )

    # -- deep lookahead: pre-stage + pre-warm the peek window ------------------

    def _take_prestaged(self, pid: int) -> Optional[Tuple[Any, int, float]]:
        """Consume a pre-staged partition's pages (uncharging its bytes)."""
        with self._slock:
            entry = self._prestaged.pop(pid, None)
            if entry is not None:
                self._staged_bytes -= entry[1]
        return entry

    def _prefetch_ahead(self, prefer: Optional[int]) -> None:
        """Walk the non-claiming peek window behind the in-flight kernel.

        The claim queue is an oracle of future work (BagPipe's observation):
        ``peek_ahead`` exposes the next ``(lookahead - 1) * K`` partitions
        beyond the chunk already staged, without claiming them.  For each
        window pid this (1) pre-warms the shared feature cache — spill
        entries promote, cold keys take the leader lease early — and
        (2) pre-stages the partition read and page-build under the byte
        budget, so the claim that eventually lands only pays a stack.
        Depth 1 keeps the classic double buffer untouched (empty window).
        """
        depth = (self._lookahead - 1) * max(self._current_k(), 1)
        if depth <= 0 or not self._stageable:
            return
        window = self._queue.peek_ahead(depth, prefer_device=prefer)
        if not window:
            return
        for pid in window:
            if self.cancelled or self._service.closed:
                return
            self._prewarm(pid)
        # sweep orphans first: a pid pre-staged earlier but claimed (and
        # possibly already produced fresh) before consumption would pin its
        # budget bytes forever
        with self._slock:
            stale = [
                p for p in self._prestaged if not self._queue.work.is_pending(p)
            ]
            for p in stale:
                _pages, nb, _s = self._prestaged.pop(p)
                self._staged_bytes -= nb
        for pid in window:
            if self.cancelled or self._service.closed:
                return
            self._prestage(pid)

    def _prewarm(self, pid: int) -> None:
        """Predictive cache probe for a future claim of `pid` (once per pid).

        Holds ``_slock`` across the lease check AND ``cache.begin`` — the
        same atomicity ``_cache_probe`` relies on so a claim can never race
        into FOLLOWING this session's own pre-warm lease (which would stall
        it behind a produce that only happens after the claim)."""
        if self._cache_key is None or not self.job.prewarm:
            return
        with self._slock:
            if pid in self._prewarmed:
                return
        try:
            key = self._cache_key(pid)  # fingerprints memoize; cheap re-walk
        except Exception:
            return  # an unprobeable pid pre-warms nothing; the claim decides
        with self._slock:
            if pid in self._prewarmed:
                return
            self._prewarmed.add(pid)
            try:
                status, _found = self._cache.begin(key, prewarm=True)
            except Exception:
                return  # a broken cache degrades pre-warm to a no-op
            if status == "produce":
                self._prewarm_leases[pid] = key
            elif status == "hit":
                self._prewarm_hits += 1
                self._prewarm_cached.add(pid)
            else:  # follow: another tenant is producing it right now
                self._prewarm_cached.add(pid)

    def _prestage(self, pid: int) -> None:
        """Read + page-build a FUTURE claim's partition under the budget.

        The budget is reserved in deterministic page-geometry bytes BEFORE
        the read, so ``staged_bytes_peak <= stage_budget_bytes`` holds as an
        invariant (never exceeded mid-read, and a budget smaller than one
        partition pre-stages nothing).  Reads charge the owning device's
        ledger inside ``store.read`` exactly as claim-time reads do."""
        if self._page_nbytes <= 0:
            return
        with self._slock:
            if (
                pid in self._prestaged
                or pid in self._staging_now
                or pid in self._prewarm_cached  # its claim will short-circuit
            ):
                return
            if self._staged_bytes + self._page_nbytes > self._stage_budget:
                return  # budget full: the rest of the window reads on claim
            self._staging_now.add(pid)
            self._staged_bytes += self._page_nbytes
            self._staged_bytes_peak = max(
                self._staged_bytes_peak, self._staged_bytes
            )
        t0 = time.perf_counter()
        try:
            pages = self.engine.stage_partition(self.job.store, pid)
        except BaseException:  # noqa: BLE001
            with self._slock:
                self._staging_now.discard(pid)
                self._staged_bytes -= self._page_nbytes
            return  # the claim-time read will surface the error to the future
        dt = time.perf_counter() - t0
        with self._slock:
            self._staging_now.discard(pid)
            self._prestaged[pid] = (pages, self._page_nbytes, dt)

    def _clear_prefetch(self) -> None:
        """Retire/cancel cleanup: drop staged-ahead pages and abandon any
        pre-warm leases never consumed by a claim (so cross-tenant followers
        of those keys re-issue real produces instead of waiting forever)."""
        with self._slock:
            self._prestaged.clear()
            self._staged_bytes = 0
            leases = list(self._prewarm_leases.values())
            self._prewarm_leases.clear()
        for key in leases:
            try:
                self._cache.abandon(key)
            except Exception:
                pass

    def _dispatch_chunk(self, chunk: "_Chunk") -> Tuple[str, Any]:
        """Launch a staged chunk.  Engine chunks dispatch ASYNChronously
        through ``TorchPreStoEngine.launch`` — the copy-in and the kernels
        run on the device while the worker stages the next chunk — so the
        return is a ``(batches, event)`` handle ``_finish_chunk`` resolves
        at delivery.  Every K takes that one path (a solo claim is a stacked
        K = 1 chunk).  Opaque produce_fn chunks run synchronously here (no
        separable stage), preserving the legacy path's semantics exactly."""
        chunk.devs = [
            self._route_begin(pid, route) for pid, _f, route in chunk.claims
        ]
        chunk.t0 = time.perf_counter()
        try:
            if chunk.pages is None:
                ((pid, _f, _r),) = chunk.claims
                return "value", [self._produce_fn(pid)]
            return "async", self.engine.launch(chunk.pages)
        except BaseException as exc:  # noqa: BLE001 — consumer re-raises
            return "error", exc

    def _finish_chunk(
        self, chunk: "_Chunk", handle: Tuple[str, Any], overlap_s: float = 0.0
    ) -> None:
        """Resolve a dispatched chunk: wait on its CUDA event (only) at
        delivery, on the worker thread and outside every lock, then complete
        every claim's future, and charge the ledgers per claim route.

        ``overlap_s`` is time the worker spent staging the NEXT chunk while
        this one's kernel ran; it is excluded from this chunk's produce time
        (it is charged to the next chunk's own ``stage_s``) so per-session
        ``produce_time_s`` and the planner's measured per-worker P never
        double-count the overlapped staging.  Of a chunk's produce seconds,
        its ``stage_s`` and the wait in ``engine.deliver`` are counted apart
        too (``SessionStats.stage_time_s``, ``deliver_wait_s``)."""
        kind, payload = handle
        wait_s = 0.0
        try:
            if kind == "error":
                for pid, _f, _r in chunk.claims:
                    self._on_produce_error(pid, payload)
                return
            if kind == "async":
                launched, done = payload
                t_wait = time.perf_counter()
                try:
                    self.engine.deliver(done)
                except BaseException as exc:  # noqa: BLE001
                    for pid, _f, _r in chunk.claims:
                        self._on_produce_error(pid, exc)
                    return
                t_end = time.perf_counter()
                wait_s = t_end - t_wait
                batches = list(launched)
            else:
                t_end = time.perf_counter()
                batches = payload
            dt = chunk.stage_s + max(0.0, t_end - chunk.t0 - overlap_s)
            n = max(len(chunk.claims), 1)
            share = dt / n
            if self._tuner is not None and chunk.pages is not None:
                # the overlap-corrected launch seconds ARE the tuner's
                # signal: staging paid by this chunk plus kernel time not
                # hidden behind the next chunk's staging
                if self._tuner.record(len(chunk.claims), dt):
                    self._on_tuned_k_changed()
            parts = (chunk.stage_s / n, wait_s / n)
            for (pid, _f, route), batch in zip(chunk.claims, batches):
                self._on_produced(pid, batch, share, route, parts)
        finally:
            for dev in chunk.devs:
                self._route_end(dev)

    def _cache_probe(self, pid: int, fresh: bool) -> Optional[Any]:
        """SessionQueue's claim-time lookup into the shared feature cache.

        A hit means another tenant (or an earlier run of this one) already
        produced this exact batch — same partition bytes, same lowered
        Transform, same placement — so the claim short-circuits without a
        produce; a follow means that batch is being produced right now, so
        the claim pends on the producer's future instead of duplicating the
        work.  Straggler re-issues (``fresh=False``) only accept finished
        hits: following the in-flight leader they are backing up would
        defeat the re-issue.  Hit/miss counts feed the planner's demand
        discount: when this session's discounted demand changes, the pool
        re-plans so the units its hits freed go to cold jobs."""
        key = self._cache_key(pid)
        if not fresh:
            # straggler backup: peek only (never follow the possibly-stuck
            # leader), and keep it out of the hit-rate tallies — the fresh
            # claim of this pid was already counted once
            return self._cache.peek(key)
        found: Optional[Any] = None
        with self._slock:
            # the lease check and the begin() probe are atomic under _slock
            # (mirrored by ``_prewarm``): the claim must CONSUME its own
            # session's pre-warm lease — following it would park the claim
            # behind a produce that only happens after the claim itself
            lease = self._prewarm_leases.pop(pid, None)
            if lease is not None:
                status = "produce"
                key = lease  # the lease's key IS this pid's key
            else:
                status, found = self._cache.begin(key)
            if status == "produce":
                self._cache_misses += 1
                # remembered for the produce's fulfill/abandon: the produce
                # path must never recompute (and possibly re-raise) the key
                self._cache_keys[pid] = key
            else:
                self._cache_hits += 1
            eff = effective_demand_units(self._demand, self._hit_rate_locked())
            changed = eff != self._eff_demand
            self._eff_demand = eff
        if changed:
            self._service._request_replan()
        if found is None and status == "produce":
            assembled = self._assemble_from_blocks(pid)
            if assembled is not None:
                # the claim is served without a produce after all: flip the
                # miss to a hit, release the leader lease by fulfilling it
                # (followers resolve, the full-batch key is now cached too)
                with self._slock:
                    self._cache_keys.pop(pid, None)
                    self._cache_misses -= 1
                    self._cache_hits += 1
                    self._block_hits += 1
                try:
                    self._cache.fulfill(key, assembled)
                except Exception:
                    self._cache.abandon(key)
                return assembled
        return found

    def _assemble_from_blocks(self, pid: int) -> Optional[Any]:
        """Serve one cold claim from the block tier, if fully covered.

        A dedup partition whose unique blocks are ALL cached (published by
        any tenant — same pool, different pids included) needs no sparse
        produce: the per-sample families run through the engine's rest
        program over a fresh (unique-bytes-charged) page read, and the
        hashed sparse blocks gather-expand from the cache on the device —
        bitwise identical to a cold produce.  The engine returns the batch
        complete on the device.  Returns None on any miss or error (the
        claim then produces normally)."""
        if self._block_key_parts is None:
            return None
        store, engine = self.job.store, self.engine
        try:
            fps = store.block_fingerprints(pid)
            if not fps:
                return None
            plan_hash, placement = self._block_key_parts
            blocks = self._cache.get_blocks(
                BlockKey(fp, plan_hash, placement) for fp in fps
            )
            if blocks is None:
                return None
            pages = engine.stage_partition(store, pid)
            if "sparse_refs" not in pages:
                return None
            return engine.assemble_from_blocks(pages, *blocks)
        except Exception:
            return None

    def _publish_blocks(self, pid: int, batch: Any) -> None:
        """Publish a cold produce's unique hashed sparse blocks (winner path).

        Classic (dup-factor-1) data short-circuits on the store's None
        fingerprints.  Publishing must never take the worker thread down."""
        if self._block_key_parts is None:
            return
        try:
            store = self.job.store
            fps = store.block_fingerprints(pid)
            if not fps:
                return
            refs = store.block_refs(pid)
            if refs is None:
                return
            ids, lens = self.engine.extract_blocks(batch, refs)
            plan_hash, placement = self._block_key_parts
            for fp, bi, bl in zip(fps, ids, lens):
                self._cache.put_block(BlockKey(fp, plan_hash, placement), bi, bl)
        except Exception:
            return
        with self._slock:
            self._blocks_published += len(fps)

    def _hit_rate_locked(self) -> float:
        probes = self._cache_hits + self._cache_misses
        return self._cache_hits / probes if probes else 0.0

    def _hit_rate(self) -> float:
        with self._slock:
            return self._hit_rate_locked()

    def _on_produced(
        self, pid: int, batch: Any, dt: float, route: Optional[str] = None,
        parts: Tuple[float, float] = (0.0, 0.0),
    ) -> None:
        """Complete `pid`'s claim with `batch`, charging `dt` produce seconds,
        of which `parts` are (staging, deliver wait)."""
        # the produce consumed real modeled resources wherever it ran —
        # winner or straggler duplicate alike (the work happened); the batch
        # BYTES are identical either way, only the ledgers differ
        if route is not None and self._costs is not None:
            if route == "isp":
                self._fleet[self._owner_of(pid)].charge_compute(self._costs.ops)
            else:
                self._fleet.charge_host(self._costs.link_bytes, self._costs.ops)
        winner = self._queue.complete(pid, batch)
        if winner and self._cache_key is not None:
            # winner-only pop: a straggler loser racing here must not steal
            # the key and suppress the winner's fulfill (which would leave
            # the in-flight future dangling for every follower)
            with self._slock:
                key = self._cache_keys.pop(pid, None)
            if key is not None:
                # the first completion populates the cache and resolves any
                # followers pending on this content's in-flight future; a
                # broken cache must never take the worker thread down
                try:
                    self._cache.fulfill(key, batch)
                except Exception:
                    self._cache.abandon(key)
                self._publish_blocks(pid, batch)
        rows = _batch_rows(batch)
        demand_changed = False
        with self._slock:
            self._produce_time += dt
            self._stage_time += parts[0]
            self._deliver_wait += parts[1]
            if not winner:
                self._duplicates += 1
            else:
                self._produced += 1
                if route == "isp" and self._owner_of is not None:
                    owner = self._owner_of(pid)
                    self._device_produced[owner] = (
                        self._device_produced.get(owner, 0) + 1
                    )
                if rows and dt > 0:
                    p = rows / dt
                    self._p_est = p if self._p_est is None else 0.5 * self._p_est + 0.5 * p
        if winner:
            demand_changed = self._maybe_reestimate_demand()
        if demand_changed:
            self._service._rebalance()

    def _maybe_reestimate_demand(self) -> bool:
        """QoS re-estimate: demand = ceil(target / measured per-worker P),
        capped.  Returns True when the demand actually moved (the caller
        then re-plans the pool)."""
        if not (self.job.target_samples_per_s and self._p_est):
            return False
        new_demand = qos_demand_units(
            self.job.target_samples_per_s, self._p_est, cap=MAX_DEMAND_UNITS
        )
        new_eff = effective_demand_units(new_demand, self._hit_rate())
        changed = False
        with self._service._lock:
            if new_demand != self._demand:
                self._demand = new_demand
                changed = True
        if changed:
            with self._slock:
                self._eff_demand = new_eff
        return changed

    def _on_tuned_k_changed(self) -> None:
        """The tuner moved K: fold the new rung's measured per-partition
        cost into the planner's per-worker P estimate and re-plan.

        A K move changes how many rows one worker slot produces per second
        (fewer dispatches amortized, different staging bulk), so waiting for
        the EMA in ``_on_produced`` to drift there lags the pool plan behind
        reality.  When the new rung already has a measurement, P is re-based
        on it directly; either way the pool re-plans through the same lazy
        trigger the feature-cache hit-rate discount uses, so
        ``planner.plan_pool`` re-balances unit shares as K converges."""
        tuner = self._tuner
        if tuner is None:
            return
        cost = tuner.arm_cost(tuner.k)
        if cost is not None and cost > 0 and self._rows_hint:
            with self._slock:
                self._p_est = self._rows_hint / cost
        if not self._maybe_reestimate_demand():
            # demand unchanged (or best-effort job): still nudge a lazy
            # re-plan so share math sees the refreshed P on its next round
            self._service._request_replan()
        else:
            self._service._rebalance()

    def _retry_claim(self, pid: int, exc: IoFaultError) -> bool:
        """Bounded-backoff recovery for one claim's retryable I/O fault.

        Returns True when the fault is absorbed: the claim is re-queued
        (embargoed ``io_backoff_s * 2**(attempt-1)`` on the queue's clock)
        and its still-pending future is resolved by a later re-produce, so
        the consumer only ever sees latency.  A ``DeviceOfflineError``
        additionally re-routes the partition's reads through the store's
        replica/failover path before the retry lands.  False means the
        retry budget is exhausted — the caller quarantines the partition.
        """
        budget = max(0, int(self.job.io_retries))
        with self._slock:
            attempt = self._fault_attempts.get(pid, 0) + 1
            if attempt > budget:
                return False
            self._fault_attempts[pid] = attempt
            self._retries += 1
        if isinstance(exc, DeviceOfflineError) and self.job.store is not None:
            store = self.job.store
            if pid not in store.failover_partitions:
                store.allow_failover(pid)
                with self._slock:
                    self._failovers += 1
                self._service.events.emit(
                    "failover", job=self.name, pid=pid,
                    device=getattr(exc, "device", None),
                )
        delay = max(0.0, float(self.job.io_backoff_s)) * (2.0 ** (attempt - 1))
        if not self._queue.requeue(pid, delay=delay):
            # a straggler twin settled (or already re-queued) this pid first;
            # this loser's error carries no new information — drop it
            with self._slock:
                self._retries -= 1
            return True
        self._service.events.emit(
            "retry", job=self.name, pid=pid, attempt=attempt,
            delay_s=round(delay, 6), fault=type(exc).__name__,
        )
        self._service._wake()
        return True

    def _on_produce_error(self, pid: int, exc: BaseException) -> None:
        if (
            isinstance(exc, IoFaultError)
            and getattr(exc, "retryable", True)
            and not self.cancelled
        ):
            if self._retry_claim(pid, exc):
                return  # absorbed: the future stays pending for the retry
        quarantine = isinstance(exc, IoFaultError)
        if quarantine:
            # budget exhausted (or the fault is non-retryable, e.g. verified
            # at-rest corruption): surface a structured error, never hang
            with self._slock:
                attempts = self._fault_attempts.get(pid, 0)
            exc = SessionError(
                f"partition {pid} of job {self.name!r} quarantined after "
                f"{attempts} I/O retr{'y' if attempts == 1 else 'ies'}: {exc}",
                job=self.name, pid=pid, attempts=attempts, cause=exc,
            )
        winner = self._queue.complete_error(pid, exc)  # duplicate losers drop
        if winner and quarantine:
            with self._slock:
                self._quarantined += 1
            self._service.events.emit(
                "quarantine", job=self.name, pid=pid, attempts=attempts,
                fault=type(exc.cause).__name__,
            )
        if winner and self._cache_key is not None:
            with self._slock:
                key = self._cache_keys.pop(pid, None)  # winner-only, as above
            if key is not None:
                # deterministic in the key: followers would fail identically
                self._cache.abandon(key, exc)


@dataclasses.dataclass
class _PoolWorker:
    """One pool worker's control-plane record (a simulated ISP unit).

    ``killed`` is the crash simulation: the thread notices at its next
    pipeline boundary, abandons whatever it holds (claims expire back
    through the straggler path), and exits without completing anything.
    ``retired`` is the graceful shrink: finish the chunk in hand, claim
    nothing new, exit.  ``chunk`` mirrors the claims currently in the
    worker's hands so ``kill_worker`` can expire them promptly even while
    the thread is deep inside a produce."""

    wid: int
    device: Optional[int]
    thread: Optional[threading.Thread] = None
    killed: threading.Event = dataclasses.field(default_factory=threading.Event)
    retired: threading.Event = dataclasses.field(default_factory=threading.Event)
    chunk: Optional[_Chunk] = None


class PreprocessingService:
    """The shared preprocessing pool: submit jobs, stream their batches.

    One fixed pool of ``num_workers`` worker threads (the provisioned
    ISP-unit fleet) serves every admitted session.  The scheduler is a
    two-pass round-robin: pass 1 respects each session's allocated share
    (QoS isolation), pass 2 is work-conserving (idle units serve any
    claimable session).  Backpressure is per-session (``SessionQueue``), so
    one slow consumer never idles the pool.

    With ``devices`` (a ``data.storage.DeviceFleet`` or a device count) the
    pool is no longer a fungible bag: each worker is an ISP unit bound to
    one device (round-robin), claims become locality-aware — a worker
    prefers partitions its own device owns, and takes a foreign partition
    only when the owning device's live queue prices the ISP path past the
    host path (``cost_model.should_offload``) or that device has no bound
    unit.  Foreign produces are HOST-fallback produces: same bytes, charged
    to the fleet's host ledger (link + host compute) instead of the device.
    ``locality=False`` keeps the fleet's ledgers but schedules blind (the
    round-robin baseline the skew bench compares against).
    """

    def __init__(
        self,
        num_workers: int = 2,
        *,
        cache: Optional[FeatureCache] = None,
        start: bool = True,
        devices: Optional[Union[int, DeviceFleet]] = None,
        locality: bool = True,
        cost_model: Optional[ContentionAwareCostModel] = None,
        pipeline: bool = True,
        admission: str = "strict",
    ):
        assert num_workers >= 1, "pool needs at least one worker"
        assert admission in ("strict", "slo"), admission
        self.cache = cache  # ONE shared feature cache across every tenant
        self.locality = locality
        # admission="slo": QoS-tiered admission (core.planner.plan_pool_slo).
        # Release-candidate jobs take surplus before exploratory ones and may
        # preempt exploratory floors; an existing session whose floor is
        # preempted keeps running on work-conserving backfill only (share 0)
        # and its slo_status says so — degrade/reject, never silent
        # starvation.  "strict" keeps the historical fail-fast behavior.
        self.admission = admission
        # pipeline=False disables the zero-stall worker path (megabatch
        # coalescing + stage/kernel overlap): every produce runs the legacy
        # synchronous claim->produce->complete loop.  The bench's serial
        # baseline and a safety hatch; batches are bitwise identical either
        # way.
        self.pipeline = pipeline
        self.cost_model = cost_model or ContentionAwareCostModel()
        if isinstance(devices, int):
            # budgets from the SAME model that prices routing decisions, so
            # the ledgers charge at the rates should_offload predicts with
            devices = (
                DeviceFleet.from_cost_model(devices, self.cost_model)
                if devices > 0 else None
            )
        self.fleet: Optional[DeviceFleet] = devices
        self._topology: Optional[DeviceTopology] = None
        self._manned: set = set()
        self._sessions: List[Session] = []
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._wake_cv = threading.Condition()
        self._rr = 0
        self._replan = False  # a session's hit-rate-discounted demand moved
        self.plan: Optional[PoolPlan] = None
        # the control plane's structured event stream: membership changes,
        # claim re-issues, checkpoints, scale decisions, plan changes
        self.events = EventLog()
        if cache is not None:
            # the spill tier publishes corrupt-block drops through the
            # service's event stream — wired BEFORE warm_start so a corrupt
            # block skipped at boot is observable too
            spill = getattr(cache, "spill", None)
            if spill is not None and getattr(spill, "events", None) is None:
                spill.events = self.events
            # feature-cache warm start: promote restart-survivable spilled
            # blocks back into the memory tier before any worker runs
            cache.warm_start()
        # pool membership is DYNAMIC (kill/join at runtime): wid -> record.
        # _all_threads keeps every thread ever spawned for join-on-close;
        # dead workers leave _workers (capacity) immediately on kill/retire.
        self._workers: Dict[int, _PoolWorker] = {}
        self._all_threads: List[threading.Thread] = []
        self._next_wid = 0
        self._started = False
        for _ in range(num_workers):
            self._spawn_worker()  # boot membership: no join events
        if start:
            self.start()

    @property
    def num_workers(self) -> int:
        """Live pool capacity (the planner's unit count) — moves with
        ``add_worker``/``remove_worker``/``kill_worker``."""
        with self._lock:
            return len(self._workers)

    def _refresh_topology(self) -> None:
        """Recompute device bindings from LIVE membership (caller holds
        ``_lock``): kill/join moves units between devices, and the planner's
        per-device shares plus host-fallback eligibility must follow."""
        if self.fleet is None:
            return
        upd = {d: 0 for d in range(len(self.fleet))}
        for w in self._workers.values():
            if w.device is not None:
                upd[w.device] += 1
        self._topology = DeviceTopology(upd)
        self._manned = self._topology.manned

    def _spawn_worker(self, device: Optional[int] = None) -> _PoolWorker:
        """Create (and, once started, launch) one pool worker.  With a
        fleet, an unpinned worker binds to the least-manned device (boot
        order reproduces the classic round-robin binding)."""
        with self._lock:
            wid = self._next_wid
            self._next_wid += 1
            if self.fleet is None:
                device = None
            elif device is None:
                counts = {d: 0 for d in range(len(self.fleet))}
                for w in self._workers.values():
                    if w.device is not None:
                        counts[w.device] += 1
                device = min(counts, key=lambda d: (counts[d], d))
            w = _PoolWorker(wid=wid, device=device)
            w.thread = threading.Thread(
                target=self._worker_loop, args=(w,), daemon=True,
                name=f"presto-pool-{wid}",
            )
            self._workers[wid] = w
            self._all_threads.append(w.thread)
            self._refresh_topology()
            started = self._started
        if started:
            w.thread.start()
        return w

    # -- elastic membership ----------------------------------------------------

    def add_worker(self, device: Optional[int] = None) -> int:
        """Grow the pool by one worker at runtime; returns its wid.  Device
        binding, topology, and pool shares re-plan immediately."""
        if self.closed:
            raise RuntimeError("preprocessing service is closed")
        w = self._spawn_worker(device)
        with self._lock:
            if self._sessions:
                self._rebalance()
        self.events.emit(
            "worker_join", worker=w.wid, device=w.device, pool=self.num_workers
        )
        self._wake()
        return w.wid

    def kill_worker(self, wid: int) -> bool:
        """Crash-simulate one pool worker (the chaos drill).

        The worker leaves capacity immediately (topology + shares re-plan);
        its in-flight claims are force-expired so the next claim round
        re-issues them through the existing straggler path — the claims'
        futures stay pending and resolve from the re-issued produce, so
        every consumer stream stays bitwise identical to a no-failure run.
        The thread itself notices at its next pipeline boundary and abandons
        whatever it holds (cache leases, device occupancy) on its way out."""
        with self._lock:
            w = self._workers.pop(wid, None)
            if w is None:
                return False
            w.killed.set()
            held = w.chunk
            self._refresh_topology()
            if self._sessions:
                self._rebalance()
        reissued = [pid for pid, _f, _r in held.claims] if held is not None else []
        if held is not None:
            held.session._expire_claims(reissued)
        self.events.emit(
            "worker_leave", worker=wid, device=w.device, reason="killed",
            pool=self.num_workers, reissued=reissued,
        )
        self._wake()
        return True

    def remove_worker(self, wid: Optional[int] = None) -> Optional[int]:
        """Gracefully retire one worker (autoscaler shrink): it finishes the
        chunk in hand, claims nothing new, and exits.  Refuses to shrink
        below one worker or below the admission floor (one schedulable unit
        per admitted session).  Returns the retired wid, or None."""
        with self._lock:
            if wid is None:
                wid = max(self._workers, default=None)  # LIFO: newest first
            if wid is None or wid not in self._workers:
                return None
            if len(self._workers) - 1 < max(1, len(self._sessions)):
                return None
            w = self._workers.pop(wid)
            w.retired.set()
            self._refresh_topology()
            if self._sessions:
                self._rebalance()
        self.events.emit(
            "worker_leave", worker=wid, device=w.device, reason="retired",
            pool=self.num_workers,
        )
        self._wake()
        return wid

    def load_snapshot(self) -> Dict[str, int]:
        """The autoscaler's policy inputs: live workers, admitted sessions,
        backlog (unfinished partitions across every session), and aggregate
        hit-rate-discounted demand units."""
        with self._lock:
            sessions = list(self._sessions)
            workers = len(self._workers)
        backlog = 0
        demand = 0
        for s in sessions:
            backlog += s._queue.work.remaining()
            demand += effective_demand_units(s._demand, s._hit_rate())
        return {
            "workers": workers,
            "sessions": len(sessions),
            "backlog": backlog,
            "demand_units": demand,
        }

    def start(self) -> "PreprocessingService":
        if not self._started:
            self._started = True
            with self._lock:
                threads = [w.thread for w in self._workers.values()]
            for t in threads:
                if t is not None and t.ident is None:
                    t.start()
        return self

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def __enter__(self) -> "PreprocessingService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _wake(self) -> None:
        """Nudge idle pool workers (new work, freed slot, or pacing signal)."""
        with self._wake_cv:
            self._wake_cv.notify_all()

    def close(self) -> None:
        """Stop the pool.  Sessions still streaming see a RuntimeError.
        A rooted spill tier gets the memory tier flushed through to it so a
        restarted service can ``warm_start`` from the full cache."""
        self._stop.set()
        self._wake()
        me = threading.current_thread()
        with self._lock:
            threads = list(self._all_threads)
        for t in threads:
            if t.is_alive() and t is not me:
                t.join(timeout=5.0)
        if self.cache is not None:
            self.cache.flush_spill()  # no-op without a rooted spill tier

    # -- job lifecycle ---------------------------------------------------------

    def _device_weights(self, extra: Optional[Session] = None):
        """Per-job device-demand weights for the planner (fleet pools only)."""
        if self._topology is None:
            return None
        sessions = list(self._sessions)
        if extra is not None and extra not in sessions:
            sessions.append(extra)
        return {
            s.name: s.device_weights
            for s in sessions
            if s.device_weights is not None
        } or None

    def submit(
        self, job: JobSpec, *, resume_from: Optional[SessionCheckpoint] = None
    ) -> Session:
        """Admit a job and return its Session (raises AdmissionError).

        ``resume_from`` (a ``SessionCheckpoint`` from a previous service
        incarnation) narrows the job to its undelivered partitions and
        re-seeds the tuner: the resumed stream picks up exactly where the
        checkpointed one stopped, and the union of both streams is bitwise
        identical to one uninterrupted run."""
        if self.closed:
            raise RuntimeError("preprocessing service is closed")
        if resume_from is not None:
            job = resume_from.apply(job)
        # A finished session retires from the worker loop's finally block,
        # which may still be running when its consumer's drain() returns —
        # prune now so back-to-back submits never fail admission against a
        # tenant that is already done.
        self._prune()
        with self._lock:
            if any(s.name == job.name for s in self._sessions):
                raise ValueError(f"job name {job.name!r} already active")
            demands = {s.name: s._demand for s in self._sessions}
            demands[job.name] = max(1, job.units or 1)
            rates = {s.name: s._hit_rate() for s in self._sessions}
            # binds device backlog on the fleet
            session = Session(self, job, resume_from=resume_from)
            try:
                if self.admission == "slo":
                    plan = self._plan_slo(
                        demands, rates, joining=session,
                        device_weights=self._device_weights(session),
                    )
                else:
                    plan = plan_pool(  # admission
                        self.num_workers, demands, rates,
                        topology=self._topology,
                        device_weights=self._device_weights(session),
                    )
            except AdmissionError:
                session._release_all_backlog()  # rejected: unbind its backlog
                raise
            self._sessions.append(session)
            self._apply(plan)
        self.events.emit(
            "session_join", job=job.name, partitions=session.total,
            demand_units=session._demand, share=session.share,
        )
        if resume_from is not None:
            self.events.emit(
                "resume", job=job.name, remaining=session.total,
                skipped=len(resume_from.delivered),
            )
        self._wake()
        return session

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "workers": self.num_workers,
                "active_jobs": [s.name for s in self._sessions],
                "shares": dict(self.plan.shares) if self.plan else {},
                "oversubscribed": bool(self.plan and self.plan.oversubscribed),
            }
            if self.plan is not None and self.plan.device_shares is not None:
                out["device_shares"] = {
                    d: dict(js) for d, js in self.plan.device_shares.items()
                }
        if self.fleet is not None:
            out["devices"] = self.fleet.utilization()
            out["host"] = {
                "busy_s": self.fleet.host_busy_s,
                "link_bytes": self.fleet.host_link_bytes,
                "produces": self.fleet.host_produces,
            }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        out["events"] = self.events.summary()
        return out

    def _apply(self, plan: PoolPlan) -> None:
        prev = self.plan.shares if self.plan is not None else None
        self.plan = plan
        for s in self._sessions:
            s.share = plan.shares.get(s.name, 0)
        if plan.shares != prev:
            self.events.emit(
                "plan", capacity=plan.capacity, shares=dict(plan.shares)
            )

    def _request_replan(self) -> None:
        """A session's effective demand moved (feature-cache hit rate shift);
        re-plan lazily on the next scheduling round rather than here — the
        caller may be deep inside a claim under several locks."""
        self._replan = True
        self._wake()

    def _plan_slo(
        self,
        demands: Dict[str, int],
        rates: Dict[str, float],
        *,
        joining: Optional[Session] = None,
        device_weights=None,
    ) -> PoolPlan:
        """QoS-tiered planning over the current sessions (plus an optionally
        joining one); caller holds ``_lock``.  Raises ``AdmissionError`` when
        the joining job itself is rejected.  An EXISTING session whose floor
        a release candidate preempted is marked ``slo_status="preempted"``
        and drops to share 0 — it keeps running on work-conserving backfill
        only until capacity returns, and the preemption is emitted as an
        event rather than happening silently."""
        sessions = list(self._sessions)
        if joining is not None:
            sessions.append(joining)
        reqs = [
            SloRequest(
                s.name, demands.get(s.name, s._demand),
                s.job.qos_class, s.job.deadline_s,
            )
            for s in sessions
        ]
        plan, decisions = plan_pool_slo(
            self.num_workers, reqs, rates,
            topology=self._topology, device_weights=device_weights,
        )
        if joining is not None:
            mine = decisions[joining.name]
            if mine.status == "rejected":
                raise AdmissionError(
                    f"job {joining.name!r} rejected: {mine.reason}"
                )
        for s in sessions:
            d = decisions.get(s.name)
            if d is None:
                continue
            prev = s.slo_status
            status = d.status
            if status == "rejected" and s is not joining:
                status = "preempted"
            s.slo_status = status
            if status == "preempted" and prev != "preempted":
                self.events.emit(
                    "preempt", job=s.name, qos_class=s.job.qos_class,
                    by=(joining.name if joining is not None else None),
                )
        return plan

    def _rebalance(self) -> None:
        with self._lock:
            self._replan = False
            demands = {s.name: s._demand for s in self._sessions}
            rates = {s.name: s._hit_rate() for s in self._sessions}
            try:
                if self.admission == "slo":
                    plan = self._plan_slo(
                        demands, rates, device_weights=self._device_weights()
                    )
                else:
                    plan = plan_pool(
                        self.num_workers, demands, rates,
                        topology=self._topology,
                        device_weights=self._device_weights(),
                    )
            except AdmissionError:
                # A crash dropped capacity below the admission floor for the
                # sessions already inside.  Degrade rather than evict: every
                # session keeps a 1-unit floor share (pass-2 work-conserving
                # scheduling keeps the pool live) until workers rejoin.
                plan = PoolPlan(
                    self.num_workers, dict(demands),
                    {j: 1 for j in demands}, effective_demand=dict(demands),
                )
            self._apply(plan)

    def _retire(self, session: Session) -> None:
        """Drop a finished/cancelled session from scheduling and rebalance."""
        session._clear_prefetch()  # staged-ahead pages + unconsumed leases
        if session._owner_of is not None:
            session._release_all_backlog()  # cancelled leftovers unbind
        removed = False
        with self._lock:
            if session in self._sessions:
                self._sessions.remove(session)
                removed = True
        if removed:
            self._rebalance()
            self.events.emit(
                "session_leave", job=session.name,
                done=session.done, cancelled=session.cancelled,
            )
        self._wake()  # freed units may unblock other tenants' pass-1 claims

    # -- the pool --------------------------------------------------------------

    def _release_slot(self, sess: Session, wdev: Optional[int]) -> None:
        with self._lock:
            sess._active_workers -= 1
            if wdev is not None:
                sess._active_by_dev[wdev] = sess._active_by_dev.get(wdev, 1) - 1

    def _next_task(
        self, wdev: Optional[int] = None, stageable_only: bool = False
    ) -> Optional[Tuple[Session, Tuple[int, Future, Optional[str]]]]:
        """Two-pass round-robin claim.  The claim itself — which may probe
        the feature cache, hash a disk partition's bytes, or read a spilled
        block — runs OUTSIDE the service lock: the worker reserves its
        session slot first (so shares stay enforced while it probes) and
        releases it if the claim comes back empty.

        ``wdev`` is the worker's bound device.  Pass 1 additionally enforces
        the plan's per-device shares (a hot device's job cannot occupy a
        cold device's units past its slice); pass 2 stays work-conserving.
        With ``locality`` on, the claim prefers partitions the worker's own
        device owns and may take foreign ones only via host fallback.
        """
        if self._replan:
            self._rebalance()  # pick up hit-rate-discounted demand shifts
        prefer = wdev if (self.locality and wdev is not None) else None
        for enforce_share in (True, False):
            with self._lock:
                n = len(self._sessions)
                candidates = [self._sessions[(self._rr + i) % n] for i in range(n)]
            for i, sess in enumerate(candidates):
                if stageable_only and not sess._stageable:
                    continue  # overlap prefetch: only separable-stage work
                with self._lock:
                    if sess.cancelled:
                        continue
                    if enforce_share and sess._active_workers >= max(sess.share, 1):
                        continue
                    if (
                        enforce_share
                        and wdev is not None
                        and self.plan is not None
                        and self.plan.device_shares is not None
                        and sess._owner_of is not None
                    ):
                        cap = self.plan.device_shares.get(wdev, {}).get(sess.name, 0)
                        if sess._active_by_dev.get(wdev, 0) >= cap:
                            continue  # this device's slice is spoken for
                    sess._active_workers += 1  # reserve before the claim
                    if wdev is not None:
                        sess._active_by_dev[wdev] = (
                            sess._active_by_dev.get(wdev, 0) + 1
                        )
                claimed = sess._queue.claim(prefer_device=prefer)
                if claimed is None:
                    self._release_slot(sess, wdev)
                    continue
                with self._lock:
                    self._rr = (self._rr + i + 1) % max(n, 1)
                return sess, claimed
        return None

    def _prune(self) -> None:
        with self._lock:
            finished = [
                s for s in self._sessions if s.cancelled or s._queue.exhausted
            ]
        for s in finished:
            self._retire(s)

    def _stage_task(
        self, sess: Session, claim, wdev: Optional[int]
    ) -> Optional[_Chunk]:
        """Coalesce + stage one claimed task into a launchable chunk.

        A failed staging has already errored its claims' futures; the
        worker's reserved slot is released here so shares stay exact."""
        prefer = wdev if (self.locality and wdev is not None) else None
        chunk = sess._stage_chunk(claim, prefer)
        if chunk is None:
            self._release_slot(sess, wdev)
            if sess._queue.exhausted:
                self._retire(sess)
            self._wake()
        return chunk

    def _worker_loop(self, w: _PoolWorker) -> None:
        """The zero-stall produce loop of one pool worker.

        Stageable (engine-backed) sessions run a double-buffered pipeline:
        claim -> coalesce up to ``JobSpec.megabatch`` compatible claims ->
        stage reads/page-builds/pins -> dispatch ONE (mega)batched launch
        asynchronously -> while it executes, claim + stage the NEXT chunk ->
        wait on the chunk's CUDA event only at delivery.  Per-partition
        cost tends to ``max(io, compute)`` instead of ``io + compute``, and
        K claims pay one dispatch.  Opaque produce_fn sessions run their legacy
        synchronous path through the same chunk machinery (no coalescing,
        no overlap — their stage is not separable).

        Elasticity (``core.ctrlplane``): the loop checks ``w.killed`` at
        pipeline boundaries.  A killed worker abandons whatever it holds —
        chunks in hand are un-routed, their cache leases dropped, and their
        claims expired back onto the straggler path so a live worker
        re-issues them; nothing it produced after the kill is delivered.
        ``w.retired`` is the graceful variant: finish the chunk in hand,
        take no new work.
        """
        wdev = w.device
        staged: Optional[_Chunk] = None
        while True:
            if w.killed.is_set():
                break  # crash: the staged chunk is abandoned after the loop
            if staged is None:
                if self._stop.is_set() or w.retired.is_set():
                    break
                task = self._next_task(wdev)
                if task is None:
                    self._prune()
                    # idle: sleep until nudged (submit / freed slot / pacing
                    # signal); the timeout keeps straggler scans alive
                    with self._wake_cv:
                        self._wake_cv.wait(timeout=0.05)
                    continue
                staged = self._stage_task(task[0], task[1], wdev)
                w.chunk = staged
                continue
            chunk, staged = staged, None
            sess = chunk.session
            try:
                handle = sess._dispatch_chunk(chunk)
                overlap_s = 0.0
                if (
                    handle[0] == "async"
                    and not self._stop.is_set()
                    and not w.killed.is_set()
                    and not w.retired.is_set()
                ):
                    # double buffering: the next chunk's partition read,
                    # page-build and pin overlap the in-flight kernels
                    t_ov = time.perf_counter()
                    nxt = self._next_task(wdev, stageable_only=True)
                    if nxt is not None:
                        staged = self._stage_task(nxt[0], nxt[1], wdev)
                    # deep lookahead: with the next chunk staged, walk the
                    # peek window further out — pre-warm the feature cache
                    # and pre-stage future claims' reads under the byte
                    # budget, all still hidden behind the in-flight kernel
                    prefer = wdev if (self.locality and wdev is not None) else None
                    (staged.session if staged is not None else sess)._prefetch_ahead(
                        prefer
                    )
                    overlap_s = time.perf_counter() - t_ov
                if w.killed.is_set():
                    # crash point: results in hand die with the worker —
                    # the claims go back through the straggler path and a
                    # live worker reproduces them (winner semantics drop
                    # any duplicate, so delivery stays bitwise identical)
                    sess._abandon_chunk(chunk)
                    if staged is not None:
                        staged.session._abandon_chunk(staged)
                        self._release_slot(staged.session, wdev)
                        staged = None
                    continue  # loop top exits on the killed flag
                sess._finish_chunk(chunk, handle, overlap_s)
            finally:
                w.chunk = staged
                self._release_slot(sess, wdev)
                if sess._queue.exhausted:
                    self._retire(sess)
                self._wake()  # a share slot freed (or the job just finished)
        if w.killed.is_set() and staged is not None:
            staged.session._abandon_chunk(staged)
            self._release_slot(staged.session, wdev)
        w.chunk = None
