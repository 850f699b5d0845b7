"""The elastic control plane: events, checkpoints, autoscaling, chaos hooks.

The port's own copy of ``repro.core.ctrlplane`` (pure Python: it needs
nothing of a device).  ``Autoscaler`` drives any object with the service's
surface.

PreSto's value claim is COST-efficiency: a preprocessing pool sized to the
work instead of a static CPU fleet.  Meta's production ingestion stack (DPP,
in the DSI paper) is the template this module reproduces around
``core.service.PreprocessingService``: stateless pool workers behind a
master that checkpoints job progress, auto-scales the pool from queue
depth / QoS targets, and survives worker loss.  Everything here is
deliberately mechanism-light because the data plane already guarantees the
hard part — partitions are deterministic, so re-producing one is always
bitwise safe:

* ``EventLog`` — a bounded ring-buffer metrics publisher (the Ray dashboard
  publisher/buffer/tail idiom): every membership change, claim re-issue,
  checkpoint, scale decision, and plan change lands here as a structured
  ``Event``; ``stats()``, ``serve_preprocess``, and the tests read it back
  via ``tail``/``since``/``counts``.
* ``SessionCheckpoint`` — a session's progress frontier (DELIVERED
  partition ids, tuner state, counters), JSON-serializable.  Delivered —
  not merely produced — is the frontier: an undelivered result dies with
  the service, so resume must re-produce it.  ``apply`` turns an original
  ``JobSpec`` into its resume spec (the remaining partitions, original
  order); determinism makes the combined pre-crash + post-resume stream
  bitwise identical to an uninterrupted run.  The feature cache's
  ``warm_start`` covers the data side of the same restart.
* ``AutoscalePolicy`` / ``Autoscaler`` — the backlog-driven policy loop:
  reads ``service.load_snapshot()`` (live workers, sessions, backlog,
  hit-rate-discounted demand units), grows the pool while the backlog per
  worker exceeds the policy's target, and shrinks it back to the floor when
  drained — every decision emitted as a ``scale_up``/``scale_down`` event.
  ``step()`` is deterministic (the tests drive it directly); ``start()``
  runs it on a background thread for the CLI.
* ``FailureInjector`` / ``SimulatedFailure`` — the shared failure-injection
  contract.  ``train.elastic.ElasticTrainer`` (the seed's elasticity
  design: regenerable data + topology-agnostic restore) injects trainer
  failures through it; the service side simulates worker crashes with
  ``PreprocessingService.kill_worker`` (in-flight claims re-issued through
  the queue's straggler path).  Same drill, both sides of the stream.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = [
    "Autoscaler",
    "AutoscalePolicy",
    "Event",
    "EventLog",
    "FailureInjector",
    "SessionCheckpoint",
    "SessionError",
    "SimulatedFailure",
    "parse_kill_spec",
]


# -- structured event stream ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Event:
    """One control-plane occurrence: monotone ``seq``, wall-clock ``ts``,
    a ``kind`` tag, and a small JSON-able payload."""

    seq: int
    ts: float
    kind: str
    data: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "ts": self.ts, "kind": self.kind,
                "data": dict(self.data)}


class EventLog:
    """Bounded-buffer event publisher (publisher/buffer/tail idiom).

    Thread-safe.  ``emit`` never blocks and never fails the caller; the ring
    keeps the newest ``capacity`` events (older ones are dropped but still
    counted), so observability can never leak memory on a long-lived pool.

    ``clock`` defaults to wall time; the discrete-event simulator injects
    its ``VirtualClock.now`` so every event is stamped with the *modeled*
    instant — with a virtual clock, same-seed runs produce byte-identical
    event traces (``dump``/``to_dicts``), which is what the deterministic-
    simulation tests diff.
    """

    def __init__(self, capacity: int = 512, *, clock=None):
        self._buf: Deque[Event] = collections.deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._seq = 0
        self._counts: Dict[str, int] = {}
        self._clock = clock or time.time

    def emit(self, kind: str, **data: Any) -> Event:
        with self._lock:
            ev = Event(self._seq, self._clock(), str(kind), data)
            self._seq += 1
            self._counts[ev.kind] = self._counts.get(ev.kind, 0) + 1
            self._buf.append(ev)
        return ev

    @property
    def emitted(self) -> int:
        """All-time emit count (>= what the ring still holds)."""
        with self._lock:
            return self._seq

    def counts(self) -> Dict[str, int]:
        """All-time per-kind counts — unaffected by ring-buffer drops."""
        with self._lock:
            return dict(self._counts)

    def tail(self, n: int = 20, kind: Optional[str] = None) -> List[Event]:
        """The newest `n` buffered events (oldest-first), optionally filtered."""
        with self._lock:
            evs = list(self._buf)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        return evs[-max(0, int(n)):]

    def since(self, seq: int) -> List[Event]:
        """Buffered events with ``seq`` strictly greater than `seq` — the
        incremental-consumer cursor (a dropped prefix is simply absent)."""
        with self._lock:
            return [e for e in self._buf if e.seq > seq]

    def to_dicts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [e.to_dict() for e in self._buf]

    def dump(self, path: str) -> None:
        """Write the buffered events as a JSON artifact (CI uploads these)."""
        with open(path, "w") as f:
            json.dump(self.to_dicts(), f, indent=2, default=str)

    def summary(self, tail: int = 8) -> Dict[str, Any]:
        """The ``stats()``-embeddable view: totals, per-kind counts, newest
        few events."""
        with self._lock:
            emitted = self._seq
            dropped = emitted - len(self._buf)
            counts = dict(self._counts)
            newest = [e.to_dict() for e in list(self._buf)[-max(0, int(tail)):]]
        return {"emitted": emitted, "dropped": dropped, "counts": counts,
                "tail": newest}


# -- session checkpoint/resume -------------------------------------------------


@dataclasses.dataclass
class SessionCheckpoint:
    """A session's progress frontier, snapshotted for restart/resume.

    ``partitions`` is the job's full deduplicated partition order;
    ``delivered`` the pids the consumer has actually received (delivery
    order).  Produced-but-undelivered batches are deliberately NOT in the
    frontier — their futures die with the service, so resume re-produces
    them (bitwise identical: partitions are deterministic).  ``tuner`` is a
    ``MegabatchTuner.summary()`` so a resumed autotuned session re-seeds at
    its converged rung instead of re-climbing; ``stats`` carries the closing
    counters for the record (a resumed session's own counters start fresh).
    """

    job: str
    partitions: List[int]
    delivered: List[int]
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tuner: Optional[Dict[str, Any]] = None

    def remaining(self) -> List[int]:
        """Partitions still owed to the consumer, in original claim order."""
        done = set(self.delivered)
        return [p for p in self.partitions if p not in done]

    @property
    def fraction_done(self) -> float:
        return len(self.delivered) / max(len(self.partitions), 1)

    def apply(self, job: Any) -> Any:
        """Derive the resume ``JobSpec`` from the original: same contract,
        remaining partitions only.  (Duck-typed via ``dataclasses.replace``
        so this module never imports the service layer.)"""
        if getattr(job, "name", None) != self.job:
            raise ValueError(
                f"checkpoint is for job {self.job!r}, not {getattr(job, 'name', None)!r}"
            )
        return dataclasses.replace(job, partitions=self.remaining())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "job": self.job,
            "partitions": [int(p) for p in self.partitions],
            "delivered": [int(p) for p in self.delivered],
            "stats": dict(self.stats),
            "tuner": self.tuner,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SessionCheckpoint":
        return SessionCheckpoint(
            job=d["job"],
            partitions=[int(p) for p in d.get("partitions", [])],
            delivered=[int(p) for p in d.get("delivered", [])],
            stats=dict(d.get("stats") or {}),
            tuner=d.get("tuner"),
        )

    def save(self, path: str) -> None:
        """Atomic write: tmp file + fsync + ``os.replace``.  A crash at any
        instant leaves either the previous checkpoint or the new one —
        never a torn half-write — so ``load`` on the survivor always
        parses."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "SessionCheckpoint":
        """Parse a checkpoint, rejecting torn/truncated JSON with a clear
        error (``ValueError`` naming the path and size) instead of a bare
        decode traceback — the restart path can then fall back to a fresh
        session rather than crash-looping on a bad file."""
        with open(path) as f:
            raw = f.read()
        try:
            d = json.loads(raw)
            if not isinstance(d, dict) or "job" not in d:
                raise ValueError("not a checkpoint object (missing 'job')")
        except ValueError as exc:
            raise ValueError(
                f"checkpoint {path!r} is torn or truncated "
                f"({len(raw)} bytes): {exc}"
            ) from exc
        return SessionCheckpoint.from_dict(d)


# -- backlog-driven autoscaling ------------------------------------------------


@dataclasses.dataclass
class AutoscalePolicy:
    """Bounds + targets for the backlog-driven scaling loop.

    The pool grows while the backlog (unfinished partitions across every
    admitted session) exceeds ``backlog_per_worker`` per live worker, never
    past ``max_workers`` or the sessions' aggregate hit-rate-discounted
    demand (scaling beyond demand buys nothing: shares are demand-capped).
    A drained pool shrinks back to the floor — ``min_workers``, but never
    below one schedulable unit per admitted session (the admission floor).
    """

    min_workers: int = 1
    max_workers: int = 8
    backlog_per_worker: float = 2.0
    cooldown_s: float = 0.0  # minimum seconds between applied scale moves
    max_step: int = 1  # workers added/removed per decision


class Autoscaler:
    """Drives ``service.add_worker``/``remove_worker`` from pool load.

    ``step()`` is one deterministic policy evaluation (tests call it
    directly); ``start(interval_s)`` runs the loop on a daemon thread until
    ``stop()`` or the service closes.  Every applied decision is emitted to
    the service's ``EventLog`` with the inputs that justified it.
    """

    def __init__(self, service: Any, policy: Optional[AutoscalePolicy] = None):
        self.service = service
        self.policy = policy or AutoscalePolicy()
        self._last_move: Optional[float] = None
        self._halt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def desired(self, snapshot: Optional[Dict[str, int]] = None) -> int:
        """Target pool size for a load snapshot (pure policy, no side
        effects): demand- and backlog-capped want, clamped to the bounds."""
        pol = self.policy
        snap = snapshot if snapshot is not None else self.service.load_snapshot()
        if snap["backlog"] <= 0:
            want = 0  # drained: fall to the floor
        else:
            want = min(
                snap["demand_units"],
                math.ceil(snap["backlog"] / max(pol.backlog_per_worker, 1e-9)),
            )
        floor = max(1, pol.min_workers, min(snap["sessions"], pol.max_workers))
        return max(floor, min(pol.max_workers, want))

    def step(self) -> int:
        """One policy evaluation; returns the worker delta actually applied
        (bounded by ``max_step``; 0 inside the cooldown window)."""
        svc = self.service
        if svc.closed:
            return 0
        now = time.monotonic()
        if (
            self._last_move is not None
            and now - self._last_move < self.policy.cooldown_s
        ):
            return 0
        snap = svc.load_snapshot()
        target = self.desired(snap)
        delta = max(
            -self.policy.max_step, min(self.policy.max_step, target - snap["workers"])
        )
        applied = 0
        for _ in range(delta):
            svc.add_worker()
            applied += 1
        for _ in range(-delta):
            if svc.remove_worker() is None:
                break  # admission floor refused the shrink
            applied -= 1
        if applied:
            self._last_move = now
            svc.events.emit(
                "scale_up" if applied > 0 else "scale_down",
                delta=applied,
                workers=svc.num_workers,
                target=target,
                backlog=snap["backlog"],
                demand_units=snap["demand_units"],
                sessions=snap["sessions"],
            )
        return applied

    def start(self, interval_s: float = 0.05) -> "Autoscaler":
        if self._thread is not None:
            return self

        def _loop() -> None:
            while not self._halt.is_set() and not self.service.closed:
                self.step()
                self._halt.wait(timeout=interval_s)

        self._thread = threading.Thread(
            target=_loop, daemon=True, name="presto-autoscaler"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._halt.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# -- shared failure injection (chaos hooks) ------------------------------------


class SimulatedFailure(RuntimeError):
    """An injected failure — distinguishable from a real production error."""


class SessionError(RuntimeError):
    """A structured, terminal per-partition session failure.

    Raised through the session iterator when the claim-path recovery policy
    exhausts a partition's poison budget (retries + failover did not help):
    the consumer gets WHICH job, WHICH partition, HOW many attempts, and the
    underlying cause — promptly, instead of a hung iterator.  Quarantining
    is deliberate: a partition that fails deterministically would otherwise
    burn the pool's retry bandwidth forever.
    """

    def __init__(
        self,
        message: str,
        *,
        job: Optional[str] = None,
        pid: Optional[int] = None,
        attempts: int = 0,
        cause: Optional[BaseException] = None,
    ):
        super().__init__(message)
        self.job = job
        self.pid = pid
        self.attempts = attempts
        self.cause = cause


@dataclasses.dataclass
class FailureInjector:
    """The shared chaos contract: raise once when execution reaches
    ``fail_at``.

    ``train.elastic.ElasticTrainer`` injects trainer-step failures through
    it (the restart replays past the injection point, so it fires at most
    once per injector); service-side drills pair it with
    ``PreprocessingService.kill_worker`` / checkpoint-restart, which
    exercise the same recovery invariant from the pool side.
    """

    fail_at: Optional[int] = None
    events: Optional[EventLog] = None
    fired: bool = False

    def check(self, step: int) -> None:
        if self.fail_at is None or self.fired or step != self.fail_at:
            return
        self.fired = True
        if self.events is not None:
            self.events.emit("failure_injected", step=step)
        raise SimulatedFailure(f"simulated failure at step {step}")


def parse_kill_spec(spec: str) -> Tuple[int, int]:
    """Parse one ``WID@N`` chaos directive -> ``(after_batches, wid)``:
    kill pool worker WID once N total batches have been delivered."""
    wid_s, sep, after_s = spec.partition("@")
    if not sep:
        raise ValueError(f"kill spec {spec!r} is not WID@AFTER_BATCHES")
    return int(after_s), int(wid_s)
