"""Partitioned distributed store: partition ownership + placement.

The port's own copy of ``repro.data.storage``: the storage fault domain
(typed I/O faults and the seeded injector, whose schedules equal the
reference's for the same seed), the simulated ISP devices and their fleet,
the file-backed, digest-verified ``PartitionedStore`` and the feature
cache's spill tier.  Everything here is host-side numpy: no page reaches a
device before ``PartitionedStore.read`` has verified it.

Models the paper's distributed storage layer (Tectonic-style): every
partition's blocks live contiguously on exactly ONE storage device, which is
the property that lets an ISP unit preprocess a whole mini-batch locally.

Two placements are expressible:

* ``presto``  — partition p is owned by the SAME mesh shard that will consume
  the resulting mini-batch slice.  Preprocessing ⇒ zero redistribution.
* ``disagg``  — partitions are owned by a disjoint "preprocessing pool" slice
  of the mesh; train-ready tensors must be redistributed to the consumers
  (copy-in/copy-out of Fig. 7(b)).

The store can be disk-backed (one file per partition) or generate-on-read
(synthetic source), which is how we simulate petabyte-scale data without
petabytes.
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.data import columnar
from repro_torch.data.columnar import (
    EncodedColumn,
    Partition,
    read_partition,
    write_partition,
)
from repro_torch.data.synth import SyntheticRecSysSource


# ---------------------------------------------------------------------------
# Storage fault domain: typed I/O faults + the seeded injector
#
# PreSto's preprocessing lives IN the storage layer, so device read errors,
# torn blocks, and offline devices are the system's primary failure domain
# (Meta's DSI characterization: production ingestion survives constant
# partial storage failures).  The exceptions below are the vocabulary the
# claim-path recovery policy (core.service) speaks: `retryable` faults are
# re-queued with backoff, a DeviceOfflineError additionally re-routes the
# partition through the host-fallback replica path, and a partition that
# keeps failing past its poison budget is quarantined with a structured
# SessionError instead of hanging the iterator.


class IoFaultError(RuntimeError):
    """Base of all storage-domain I/O faults.

    ``retryable`` tells the claim-path policy whether re-reading can ever
    succeed (a torn DMA: yes; verified at-rest corruption: no — retrying
    the same bytes fails identically, so quarantine immediately)."""

    def __init__(
        self,
        message: str,
        *,
        pid: Optional[int] = None,
        device: Optional[int] = None,
        retryable: bool = True,
    ):
        super().__init__(message)
        self.pid = pid
        self.device = device
        self.retryable = retryable


class TransientReadError(IoFaultError):
    """A read failed in a way that a retry can fix (bus hiccup, timeout)."""


class CorruptPartitionError(IoFaultError):
    """A partition read failed end-to-end integrity verification."""


class CorruptBlockError(IoFaultError):
    """A spilled cache block failed integrity verification."""


class DeviceOfflineError(IoFaultError):
    """The partition's owning device is offline; failover is the fix."""


class IoFaultInjector:
    """Seeded, deterministic I/O fault injection for the storage layer.

    Composes with ``ctrlplane.FailureInjector`` (worker crashes) to cover
    the data-fault half of the chaos story: transient read errors, torn
    (bit-flipped) partition reads, corrupt-at-rest spill blocks, slow reads,
    and whole-device-offline.  Attach one to a ``PartitionedStore`` and/or a
    ``CacheSpillStore``; with no injector attached the hot paths are
    untouched.

    Determinism: every fault decision hashes ``(seed, op, ident, attempt)``
    — NOT a shared RNG — so the decision for a given read attempt is
    independent of thread interleaving, and the same seed replays the same
    fault schedule under the virtual-clock sim engine.  Per-ident attempt
    counters advance under a lock, so retries of the same partition see
    fresh rolls and a transient fault eventually clears.

    ``offline_device``/``offline_after`` model one whole device going dark:
    the trigger fires once when the total partition-read count reaches
    ``offline_after`` (the ``FailureInjector`` fire-once idiom), marks the
    fleet device ``offline`` and fails every read of its partitions until
    the claim path grants failover (``PartitionedStore.allow_failover``).

    ``events`` is the duck-typed EventLog hook (``emit(kind, **data)``) —
    this module never imports ``core``; ``sleep`` is injectable so
    virtual-time runs pass ``VirtualClock.sleep`` and slow-read faults
    advance modeled time instead of blocking a real thread.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        transient: float = 0.0,
        corrupt: float = 0.0,
        spill: float = 0.0,
        slow: float = 0.0,
        slow_s: float = 1e-3,
        offline_device: Optional[int] = None,
        offline_after: Optional[int] = None,
        sleep: Optional[Callable[[float], None]] = None,
        events: Any = None,
    ):
        for name, p in (("transient", transient), ("corrupt", corrupt),
                        ("spill", spill), ("slow", slow)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} is not a probability")
        self.seed = int(seed)
        self.transient = float(transient)
        self.corrupt = float(corrupt)
        self.spill = float(spill)
        self.slow = float(slow)
        self.slow_s = float(slow_s)
        self.offline_device = offline_device
        self.offline_after = offline_after
        self.sleep = sleep if sleep is not None else time.sleep
        self.events = events
        self._lock = threading.Lock()
        self._attempts: Dict[tuple, int] = {}  # (op, ident) -> attempt count
        self._reads = 0  # total partition reads (the offline trigger's clock)
        self.offline_devices: set[int] = set()
        self.injected: Dict[str, int] = {}  # fault kind -> count

    # -- plumbing --------------------------------------------------------------
    def _roll(self, op: str, ident, attempt: int) -> float:
        """Uniform [0, 1) decision value for one (op, ident, attempt)."""
        h = hashlib.sha256(
            f"{self.seed}:{op}:{ident}:{attempt}".encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / float(1 << 64)

    def _next_attempt(self, op: str, ident) -> int:
        with self._lock:
            n = self._attempts.get((op, ident), 0) + 1
            self._attempts[(op, ident)] = n
            return n

    def _count(self, fault: str) -> None:
        with self._lock:
            self.injected[fault] = self.injected.get(fault, 0) + 1

    def _emit(self, kind: str, **data) -> None:
        ev = self.events
        if ev is None:
            return
        try:
            ev.emit(kind, **data)
        except Exception:
            pass  # a broken observer never breaks the data path

    # -- partition reads -------------------------------------------------------
    def on_partition_read(self, store: "PartitionedStore", pid: int) -> int:
        """Pre-read hook: offline / slow / transient faults.  Returns the
        attempt number (the corrupt roll's salt).  Raises on injected
        failure — the store never performs the read."""
        with self._lock:
            self._reads += 1
            reads = self._reads
            attempt = self._attempts.get(("part", pid), 0) + 1
            self._attempts[("part", pid)] = attempt
        if (
            self.offline_device is not None
            and self.offline_after is not None
            and reads >= self.offline_after
        ):
            with self._lock:
                newly = self.offline_device not in self.offline_devices
                if newly:
                    self.offline_devices.add(self.offline_device)
            if newly:
                if store.fleet is not None and 0 <= self.offline_device < len(
                    store.fleet
                ):
                    store.fleet[self.offline_device].offline = True
                self._count("device_offline")
                self._emit(
                    "device_offline",
                    device=self.offline_device,
                    after_reads=self.offline_after,
                )
        dev = store.owner_of(pid)
        if dev in self.offline_devices and not store.is_failover(pid):
            self._count("offline_read")
            self._emit("io_fault", fault="device_offline", pid=pid, device=dev)
            raise DeviceOfflineError(
                f"device {dev} is offline (partition {pid})",
                pid=pid, device=dev,
            )
        if self.slow > 0 and self._roll("slow", pid, attempt) < self.slow:
            self._count("slow_read")
            self._emit(
                "io_fault", fault="slow_read", pid=pid, attempt=attempt,
                delay_s=self.slow_s,
            )
            if self.slow_s > 0:
                self.sleep(self.slow_s)
        if self.transient > 0 and self._roll("transient", pid, attempt) < (
            self.transient
        ):
            self._count("transient")
            self._emit(
                "io_fault", fault="transient", pid=pid, device=dev,
                attempt=attempt,
            )
            raise TransientReadError(
                f"transient read error on partition {pid} "
                f"(device {dev}, attempt {attempt})",
                pid=pid, device=dev,
            )
        return attempt

    def maybe_corrupt_partition(
        self, pid: int, part: Partition, attempt: int
    ) -> Partition:
        """Torn-read model: with probability ``corrupt``, return a COPY of
        the partition with one page word bit-flipped.  The authoritative
        content (file / source) stays clean, so a retry can succeed; the
        store's digest verification catches the flip, so the corrupt copy is
        never delivered."""
        if self.corrupt <= 0 or self._roll("corrupt", pid, attempt) >= (
            self.corrupt
        ):
            return part
        bad = Partition(
            part.partition_id,
            part.schema,
            {
                n: EncodedColumn(c.schema, dict(c.pages))
                for n, c in part.columns.items()
            },
        )
        for cname in sorted(bad.columns):
            col = bad.columns[cname]
            for pname in sorted(col.pages):
                words = col.pages[pname]
                if words.size == 0:
                    continue
                flipped = np.array(words, dtype=np.uint32)
                flipped[attempt % flipped.size] ^= np.uint32(0xFFFFFFFF)
                flipped.setflags(write=False)
                col.pages[pname] = flipped
                self._count("corrupt")
                self._emit(
                    "io_fault", fault="corrupt", pid=pid, attempt=attempt,
                    page=f"{cname}/{pname}",
                )
                return bad
        return part

    # -- spill blocks ----------------------------------------------------------
    def on_spill_read(self, key: str) -> bool:
        """True → fail this spill read (the caller treats it as a miss and
        recomputes cold — latency, never wrong bytes)."""
        if self.transient <= 0:
            return False
        attempt = self._next_attempt("spillr", key)
        if self._roll("spill_transient", key, attempt) < self.transient:
            self._count("spill_transient")
            self._emit(
                "io_fault", fault="spill_transient", key=key, attempt=attempt
            )
            return True
        return False

    def maybe_corrupt_spill(
        self, key: str, arrays: Dict[str, np.ndarray]
    ) -> Dict[str, np.ndarray]:
        """Corrupt-at-rest model: with probability ``spill``, flip one byte
        of one stored array (a copy).  The block's write-time checksum is
        computed over the CLEAN arrays, so the next read detects the damage,
        drops the block, and recomputes."""
        attempt = self._next_attempt("spillw", key)
        if self.spill <= 0 or self._roll("spill_corrupt", key, attempt) >= (
            self.spill
        ):
            return arrays
        bad = dict(arrays)
        for k in sorted(bad):
            a = np.asarray(bad[k])
            if a.nbytes == 0:
                continue
            raw = bytearray(a.tobytes())
            raw[0] ^= 0xFF
            b = np.frombuffer(bytes(raw), dtype=a.dtype).reshape(a.shape)
            b.setflags(write=False)
            bad[k] = b
            self._count("spill_corrupt")
            self._emit("io_fault", fault="spill_corrupt", key=key, array=k)
            return bad
        return arrays

    def summary(self) -> Dict[str, int]:
        """Injected fault counts by kind (for asserts and reports)."""
        with self._lock:
            return dict(self.injected)


def parse_iofault_spec(spec: str) -> IoFaultInjector:
    """Build an ``IoFaultInjector`` from a compact CLI spec string.

    Comma-separated knobs, e.g.::

        transient=0.2,corrupt=0.1,spill=0.3,slow=0.05:0.01,offline=2@6,seed=7

    - ``transient=P``  transient read-error probability per attempt
    - ``corrupt=P``    torn (bit-flipped) partition read probability
    - ``spill=P``      corrupt-at-rest probability per spilled block write
    - ``slow=P[:S]``   slow-read probability, each costing S seconds (1 ms)
    - ``offline=D@N``  device D goes offline at the Nth partition read
    - ``seed=K``       fault-schedule seed (default 0)
    """
    kw: Dict[str, Any] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        k, sep, v = item.partition("=")
        if not sep:
            raise ValueError(f"io-fault knob {item!r} wants KEY=VALUE")
        k, v = k.strip(), v.strip()
        if k in ("transient", "corrupt", "spill"):
            kw[k] = float(v)
        elif k == "slow":
            rate, _, secs = v.partition(":")
            kw["slow"] = float(rate)
            if secs:
                kw["slow_s"] = float(secs)
        elif k == "offline":
            dev, sep2, after = v.partition("@")
            if not sep2:
                raise ValueError(f"offline wants DEV@N, got {v!r}")
            kw["offline_device"] = int(dev)
            kw["offline_after"] = int(after)
        elif k == "seed":
            kw["seed"] = int(v)
        else:
            raise ValueError(f"unknown io-fault knob {k!r} in {spec!r}")
    return IoFaultInjector(**kw)


class IspDevice:
    """One simulated in-storage processing unit: the schedulable resource.

    A device has an identity, rate budgets (SSD->FPGA stream rate, ISP compute
    roofline — defaults mirror ``core.costmodel.PlacementCostModel``), and an
    occupancy ledger.  Everything that touches the device charges the SAME
    ledger: partition reads (``PartitionedStore.read``), spill-tier traffic
    (``CacheSpillStore``), and ISP-routed Transform compute
    (``core.service``) all contend for the one modeled unit.  ``busy_s``
    serializes stream and compute seconds (a SmartSSD's FPGA streams pages,
    then runs the chain), which is the pessimistic end of the roofline the
    cost model prices with ``max(...)`` — good enough to rank devices.

    ``queue_depth`` is the scheduling signal: partitions bound to this device
    that have not yet completed (or been offloaded to a host worker).  The
    locality-aware claim path reads it live to decide host fallback.
    Thread-safe; counters are read without the lock (point-in-time reads of
    ints are fine for scheduling heuristics).
    """

    def __init__(
        self,
        device_id: int,
        *,
        stream_bytes_per_s: float = 8e9,
        compute_ops_per_s: float = 5e9,
    ):
        self.device_id = device_id
        self.stream_bytes_per_s = stream_bytes_per_s
        self.compute_ops_per_s = compute_ops_per_s
        self._lock = threading.Lock()
        self.bytes_streamed = 0  # partition reads + spill blocks, one stream
        self.spill_bytes = 0  # subset of bytes_streamed owed to the cache tier
        self.compute_ops = 0.0  # ISP-routed Transform ops run on this unit
        self.busy_s = 0.0  # modeled occupancy: stream + compute, serialized
        self.spill_io_s = 0.0  # subset of busy_s owed to the spill tier
        self.queue_depth = 0  # bound partitions not yet completed/offloaded
        self.inflight = 0  # claims executing on this unit right now
        self.max_inflight = 0  # high-water mark of `inflight`
        self.isp_claims = 0  # claims produced here (locality or blind)
        self.host_fallbacks = 0  # claims this device shed to the host path
        # Fault domain: an offline device serves NO reads or compute — the
        # IoFaultInjector sets this at its trigger, and the claim path
        # re-routes the device's partitions through the host-fallback
        # replica path (PartitionedStore.allow_failover).
        self.offline = False
        # Virtual-time occupancy (core.simclock): the instant this unit next
        # becomes idle.  Wall-clock paths never touch it; the discrete-event
        # engine reserves the unit through `reserve`, which both advances
        # free_at and charges the same busy_s ledger the wall-clock paths
        # charge — so a simulated schedule and a threaded run of the same
        # work agree on total device seconds.
        self.free_at = 0.0

    # -- ledger ----------------------------------------------------------------
    def charge_stream(self, nbytes: int, *, spill: bool = False) -> float:
        """Move `nbytes` through the SSD->FPGA stream; returns modeled s."""
        dt = nbytes / self.stream_bytes_per_s
        with self._lock:
            self.bytes_streamed += int(nbytes)
            self.busy_s += dt
            if spill:
                self.spill_bytes += int(nbytes)
                self.spill_io_s += dt
        return dt

    def charge_compute(self, ops: float) -> float:
        """Run `ops` abstract Transform ops on the unit; returns modeled s."""
        dt = ops / self.compute_ops_per_s
        with self._lock:
            self.compute_ops += ops
            self.busy_s += dt
        return dt

    # -- virtual-time occupancy ------------------------------------------------
    def reserve(
        self, now: float, service_s: float, *, nbytes: int = 0, ops: float = 0.0
    ) -> tuple:
        """Reserve the unit for ``service_s`` modeled seconds, starting no
        earlier than ``now``: returns ``(start, end)`` with
        ``start = max(now, free_at)`` — the device is busy *in time*, so a
        claim arriving while the unit works waits out the queue.  Charges
        the same ledger counters as the wall-clock ``charge_*`` path (do not
        combine both for one produce)."""
        with self._lock:
            start = max(now, self.free_at)
            end = start + service_s
            self.free_at = end
            self.busy_s += service_s
            self.bytes_streamed += int(nbytes)
            self.compute_ops += ops
            return start, end

    # -- occupancy -------------------------------------------------------------
    def enqueue(self, n: int = 1) -> None:
        """`n` more partitions are bound to this device (backlog grows)."""
        with self._lock:
            self.queue_depth += n

    def dequeue(self, n: int = 1) -> None:
        """`n` bound partitions completed or were offloaded to the host."""
        with self._lock:
            self.queue_depth = max(0, self.queue_depth - n)

    def shed(self) -> None:
        """One bound partition was offloaded to the host path."""
        with self._lock:
            self.host_fallbacks += 1

    def begin_claim(self) -> None:
        with self._lock:
            self.inflight += 1
            self.max_inflight = max(self.max_inflight, self.inflight)
            self.isp_claims += 1

    def end_claim(self) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - 1)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "device": self.device_id,
                "busy_s": self.busy_s,
                "queue_depth": self.queue_depth,
                "inflight": self.inflight,
                "max_inflight": self.max_inflight,
                "isp_claims": self.isp_claims,
                "host_fallbacks": self.host_fallbacks,
                "offline": self.offline,
                "bytes_streamed": self.bytes_streamed,
                "spill_bytes": self.spill_bytes,
                "compute_ops": self.compute_ops,
                "spill_io_s": self.spill_io_s,
            }

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return (
            f"IspDevice({self.device_id}, busy={self.busy_s * 1e3:.2f}ms, "
            f"queue={self.queue_depth})"
        )


class DeviceFleet:
    """The shared registry of simulated ISP devices, plus the host ledger.

    One fleet object is threaded through every layer that touches devices —
    ``PartitionedStore`` (partition reads), ``CacheSpillStore`` (spill
    traffic), and ``core.service.PreprocessingService`` (claim routing,
    compute charges) — so contention is modeled against one shared set of
    ledgers rather than per-layer copies.  Host-fallback produces charge the
    fleet-level host ledger: encoded pages + train-ready tensors cross the
    link, and the chain runs at host compute rate.
    """

    def __init__(
        self,
        num_devices: int = 4,
        *,
        stream_bytes_per_s: float = 8e9,
        compute_ops_per_s: float = 5e9,
        link_bytes_per_s: float = 3e9,
        host_ops_per_s: float = 100e9,
    ):
        if num_devices < 1:
            raise ValueError(f"num_devices={num_devices} must be >= 1")
        self.devices = [
            IspDevice(
                d,
                stream_bytes_per_s=stream_bytes_per_s,
                compute_ops_per_s=compute_ops_per_s,
            )
            for d in range(num_devices)
        ]
        self.link_bytes_per_s = link_bytes_per_s
        self.host_ops_per_s = host_ops_per_s
        self._lock = threading.Lock()
        self.host_busy_s = 0.0  # link transfer + host compute, serialized
        self.host_link_bytes = 0
        self.host_ops = 0.0
        self.host_produces = 0
        # Virtual-time host occupancy: one free_at instant per provisioned
        # host worker slot (lazily sized by `reserve_host`'s parallelism).
        self._host_free_at: List[float] = []

    @classmethod
    def from_cost_model(cls, num_devices: int, model) -> "DeviceFleet":
        """Budgets taken from a ``core.costmodel.PlacementCostModel`` (duck-
        typed so this module never imports the cost model)."""
        return cls(
            num_devices,
            stream_bytes_per_s=model.isp_stream_bytes_per_s,
            compute_ops_per_s=model.isp_ops_per_s,
            link_bytes_per_s=model.link_bytes_per_s,
            host_ops_per_s=model.host_ops_per_s,
        )

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, device_id: int) -> IspDevice:
        return self.devices[device_id]

    def __iter__(self):
        return iter(self.devices)

    def charge_host(self, link_bytes: int, ops: float) -> float:
        """One host-fallback produce: pages in + tensors out over the link,
        chain at host compute rate.  Returns modeled seconds."""
        dt = link_bytes / self.link_bytes_per_s + ops / self.host_ops_per_s
        with self._lock:
            self.host_busy_s += dt
            self.host_link_bytes += int(link_bytes)
            self.host_ops += ops
            self.host_produces += 1
        return dt

    def reserve_host(
        self,
        now: float,
        service_s: float,
        *,
        link_bytes: int = 0,
        ops: float = 0.0,
        parallelism: int = 1,
    ) -> tuple:
        """Virtual-time twin of ``charge_host``: reserve the earliest-free of
        ``parallelism`` host worker slots for ``service_s`` modeled seconds
        starting no earlier than ``now``; returns ``(start, end)``.  Ledger
        counters are charged exactly as ``charge_host`` would (do not call
        both for one produce).  Slot choice is deterministic: the lowest-
        indexed slot among the earliest free."""
        with self._lock:
            while len(self._host_free_at) < max(parallelism, 1):
                self._host_free_at.append(0.0)
            slot = min(
                range(max(parallelism, 1)), key=lambda i: self._host_free_at[i]
            )
            start = max(now, self._host_free_at[slot])
            end = start + service_s
            self._host_free_at[slot] = end
            self.host_busy_s += service_s
            self.host_link_bytes += int(link_bytes)
            self.host_ops += ops
            self.host_produces += 1
            return start, end

    def utilization(self) -> List[Dict[str, float]]:
        return [d.snapshot() for d in self.devices]

    def max_busy_s(self) -> float:
        return max(d.busy_s for d in self.devices)

    def makespan_s(self, host_parallelism: int = 1) -> float:
        """Modeled end-to-end seconds: each device serializes its own ledger;
        host work parallelizes across `host_parallelism` provisioned host
        workers.  The bottleneck resource is the makespan."""
        return max(self.max_busy_s(), self.host_busy_s / max(host_parallelism, 1))


def zipf_owner_map(
    num_partitions: int, num_devices: int, alpha: float, seed: int = 0
) -> List[int]:
    """Zipf-skewed partition->device ownership (Meta's ingestion skew).

    Device d's ownership quota follows the Zipf pmf rank^(-alpha) via largest
    remainder (exact counts, never a lucky uniform draw), then the assignment
    order is shuffled deterministically by `seed` so contiguous pid ranges
    don't all land on one device.  alpha=0 degenerates to uniform quotas.
    """
    if num_partitions < 1 or num_devices < 1:
        raise ValueError(
            f"num_partitions={num_partitions} and num_devices={num_devices} "
            "must be >= 1"
        )
    ranks = np.arange(1, num_devices + 1, dtype=np.float64)
    w = ranks ** -float(alpha)
    w /= w.sum()
    quotas = w * num_partitions
    counts = [math.floor(q) for q in quotas]
    rema = sorted(
        range(num_devices), key=lambda d: quotas[d] - counts[d], reverse=True
    )
    for d in rema[: num_partitions - sum(counts)]:
        counts[d] += 1
    owners = [d for d in range(num_devices) for _ in range(counts[d])]
    rng = np.random.default_rng(seed)
    rng.shuffle(owners)
    return [int(d) for d in owners]


class PartitionedStore:
    def __init__(
        self,
        num_partitions: int,
        num_devices: int,
        source: Optional[SyntheticRecSysSource] = None,
        root: Optional[str] = None,
        placement: str = "presto",
        *,
        fleet: Optional[DeviceFleet] = None,
        owner_map: Optional[Sequence[int]] = None,
        fault_injector: Optional[IoFaultInjector] = None,
    ):
        if num_partitions < 1 or num_devices < 1:
            raise ValueError(
                f"num_partitions={num_partitions} and num_devices={num_devices} "
                "must be >= 1"
            )
        if placement not in ("presto", "disagg"):
            raise ValueError(f"placement={placement!r} is not presto or disagg")
        if fleet is not None and num_devices != len(fleet):
            raise ValueError(
                f"num_devices={num_devices} but the shared fleet has "
                f"{len(fleet)} device(s)"
            )
        self.num_partitions = num_partitions
        self.num_devices = num_devices
        self.source = source
        self.root = root
        self.placement = placement
        self.fleet = fleet  # shared ledgers: reads charge the owning device
        if owner_map is not None:
            owner_map = [int(d) for d in owner_map]
            if len(owner_map) != num_partitions:
                raise ValueError(
                    f"owner_map covers {len(owner_map)} of {num_partitions} "
                    "partitions"
                )
            if not all(0 <= d < num_devices for d in owner_map):
                raise ValueError(f"owner_map names a device outside [0, {num_devices})")
        self.owner_map = owner_map
        self._read_bytes = 0
        self._logical_read_bytes = 0
        # pid -> (stat signature | None, fingerprint); guarded by _fp_lock
        self._fp_cache: Dict[int, tuple] = {}
        # pid -> (stat signature, (fingerprints, refs) | None); file-backed
        # dedup metadata only (source-backed derivation is cheap every call)
        self._blockfp_cache: Dict[int, tuple] = {}
        self._fp_lock = threading.Lock()
        # reads come from several loader threads: the byte counters too
        self._read_lock = threading.Lock()
        # Fault domain: with an injector attached, every read is verified
        # against the trusted content digest below before delivery; pids in
        # _failover read through the host/replica path (their owning device
        # is offline) and charge the fleet's host-link ledger instead.
        self.fault_injector = fault_injector
        self._failover: set[int] = set()
        self._digest_cache: Dict[int, str] = {}  # pid -> trusted digest

    # -- ownership -----------------------------------------------------------
    def owner_of(self, partition_id: int) -> int:
        """Storage device that holds this partition.  Round-robin by default;
        an explicit ``owner_map`` expresses skewed placements (hot devices own
        disproportionately many partitions — the contention the device-aware
        scheduler manages).  Ownership never changes partition CONTENT: the
        same pid yields the same bytes under any map."""
        if self.owner_map is not None:
            return self.owner_map[partition_id]
        return partition_id % self.num_devices

    def device_of(self, partition_id: int) -> Optional[IspDevice]:
        """The owning ``IspDevice`` when a shared fleet is attached."""
        if self.fleet is None:
            return None
        return self.fleet[self.owner_of(partition_id)]

    def partitions_of(self, device: int) -> List[int]:
        return [
            pid for pid in range(self.num_partitions) if self.owner_of(pid) == device
        ]

    # -- I/O -------------------------------------------------------------------
    def materialize(self, partition_ids: Iterable[int]) -> None:
        """Write partitions to disk (one columnar file each)."""
        if not (self.root and self.source):
            raise ValueError("materialize needs both a root and a source")
        os.makedirs(self.root, exist_ok=True)
        for pid in partition_ids:
            path = self._path(pid)
            if not os.path.exists(path):
                write_partition(path, self.source.partition(pid))

    def read(self, partition_id: int) -> Partition:
        """Fetch one partition off its owning device and charge its bytes.

        With a fault injector attached the read is verified against the
        partition's pinned content digest: a torn copy raises a retryable
        ``CorruptPartitionError``, a damaged file a non-retryable one, and a
        corrupt partition is never returned."""
        if not 0 <= partition_id < self.num_partitions:
            raise IndexError(
                f"partition {partition_id} outside [0, {self.num_partitions})"
            )
        inj = self.fault_injector
        if inj is None:
            part = self._read_raw(partition_id)
            self._account_read(
                partition_id, part.nbytes(), part.logical_nbytes()
            )
            return part
        # fault-injected read: pre-read faults (offline/slow/transient) may
        # raise before any bytes move; the clean read then pins the trusted
        # digest; a torn-read corruption lands on a COPY and is caught by
        # verification — a corrupt partition is never returned, only raised.
        attempt = inj.on_partition_read(self, partition_id)
        try:
            part = self._read_raw(partition_id)
        except columnar.CorruptPartitionFile as e:
            # verified at-rest corruption: retrying the same bytes fails
            # identically, so surface it non-retryable (quarantine fast)
            raise CorruptPartitionError(
                str(e), pid=partition_id,
                device=self.owner_of(partition_id), retryable=False,
            ) from e
        self._account_read(partition_id, part.nbytes(), part.logical_nbytes())
        want = self.content_digest(partition_id, part)
        delivered = inj.maybe_corrupt_partition(partition_id, part, attempt)
        if delivered is not part:
            got = columnar.partition_digest(delivered)
            if got != want:
                raise CorruptPartitionError(
                    f"partition {partition_id} failed integrity verification "
                    f"(want {want}, got {got}, attempt {attempt})",
                    pid=partition_id, device=self.owner_of(partition_id),
                )
        return delivered

    def _read_raw(self, partition_id: int) -> Partition:
        """The unverified read: disk file wins, else the synthetic source."""
        if self.root is not None:
            path = self._path(partition_id)
            if os.path.exists(path):
                return read_partition(path)
        if self.source is None:
            raise FileNotFoundError(
                f"partition {partition_id}: no disk file and no synthetic source"
            )
        return self.source.partition(partition_id)

    def content_digest(
        self, partition_id: int, part: Optional[Partition] = None
    ) -> str:
        """Trusted write-time digest of one partition's page content.

        Pinned on first computation (the clean read, or write time via an
        explicit call) and compared against every subsequent delivered read
        when a fault injector is attached — the end-to-end integrity anchor.
        Pass ``part`` when the clean partition is already in hand to avoid
        a second read."""
        with self._fp_lock:
            hit = self._digest_cache.get(partition_id)
        if hit is not None:
            return hit
        if part is None:
            part = self._read_raw(partition_id)
        d = columnar.partition_digest(part)
        with self._fp_lock:
            self._digest_cache[partition_id] = d
        return d

    # -- failover --------------------------------------------------------------
    def allow_failover(self, partition_id: int) -> None:
        """Grant replica reads for one partition of an offline device: its
        reads stop raising ``DeviceOfflineError`` and charge the fleet's
        host-link ledger (the replica crosses the link) instead of the dark
        device.  Content is unchanged — same pid, same bytes, still
        digest-verified."""
        with self._fp_lock:
            self._failover.add(partition_id)

    def is_failover(self, partition_id: int) -> bool:
        with self._fp_lock:
            return partition_id in self._failover

    @property
    def failover_partitions(self) -> List[int]:
        with self._fp_lock:
            return sorted(self._failover)

    def _account_read(
        self, partition_id: int, nbytes: int, logical_nbytes: int | None = None
    ) -> None:
        """Every partition read streams off its OWNING device: charge that
        device's shared ledger (when a fleet is attached) so reads contend
        with ISP compute and cache spills for the same modeled bandwidth.

        ``nbytes`` is the partition's STORED size — for dedup partitions the
        unique block bytes (``Partition.nbytes``), which is exactly what the
        device streams; ``logical_nbytes`` rides along for the savings
        report (``logical_bytes_read - bytes_read`` = bytes dedup kept off
        the devices).  Failover reads (owning device offline) pull the
        replica over the host link instead."""
        with self._read_lock:
            self._read_bytes += nbytes
            self._logical_read_bytes += (
                logical_nbytes if logical_nbytes is not None else nbytes
            )
        if self.fleet is not None:
            if self.is_failover(partition_id):
                self.fleet.charge_host(nbytes, 0.0)
            else:
                self.fleet[self.owner_of(partition_id)].charge_stream(nbytes)

    @property
    def bytes_read(self) -> int:
        with self._read_lock:
            return self._read_bytes

    @property
    def logical_bytes_read(self) -> int:
        """Bytes the same reads would have streamed without dedup."""
        with self._read_lock:
            return self._logical_read_bytes

    # -- content identity ------------------------------------------------------
    def partition_fingerprint(self, partition_id: int) -> str:
        """Content-addressed identity of one partition's encoded bytes.

        Mirrors ``read()``'s precedence exactly: when a disk file exists it
        IS the content (read() serves its bytes even on a sourced store), so
        the fingerprint hashes the file bytes, revalidated against the
        file's (mtime, size) so a rewritten partition never serves a stale
        cache key.  Only fileless partitions fall back to the source's
        deterministic (cfg, rows, seed, pid) identity.  Equal fingerprint ⇒
        equal bytes, always — a mismatch between tenants can only cost a
        missed dedup, never a wrong batch.  This is the ``partition
        fingerprint`` component of a feature-cache key."""
        path = self._path(partition_id) if self.root is not None else None
        if path is not None and os.path.exists(path):
            st = os.stat(path)
            sig = (st.st_mtime_ns, st.st_size)
            with self._fp_lock:
                hit = self._fp_cache.get(partition_id)
            if hit is not None and hit[0] == sig:
                return hit[1]
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            fp = h.hexdigest()[:16]
            with self._fp_lock:
                self._fp_cache[partition_id] = (sig, fp)
            return fp
        if self.source is None:
            raise FileNotFoundError(
                f"partition {partition_id}: no disk file and no synthetic source"
            )
        with self._fp_lock:
            hit = self._fp_cache.get(partition_id)
        if hit is not None and hit[0] is None:
            return hit[1]
        fp = hashlib.sha256(
            f"{self.source.fingerprint()}:{partition_id}".encode()
        ).hexdigest()[:16]
        with self._fp_lock:
            self._fp_cache[partition_id] = (None, fp)
        return fp

    def block_fingerprints(self, partition_id: int) -> Optional[List[str]]:
        """Content identity of each unique sparse block (dedup datasets).

        None for classic (dup-factor-1) data.  Mirrors ``read()``'s file vs
        source precedence like ``partition_fingerprint``: a disk file's
        blocks hash their decoded content (``columnar.block_fingerprints``,
        cached against the file's stat signature); fileless partitions use
        the source's deterministic identity — ``(source fp, pool id)`` when
        blocks come from a dataset-level pool (``RMDataConfig.dup_pool``, the
        cross-partition overlap case) else ``(source fp, pid, block idx)`` —
        with no content generation at probe time.  Equal fingerprint ⇒ equal
        decoded block, always; the two derivations never match each other,
        which can only cost a missed block-cache dedup, never a wrong batch.
        """
        meta = self._block_meta(partition_id)
        return meta[0] if meta is not None else None

    def block_refs(self, partition_id: int) -> Optional[np.ndarray]:
        """The (rows,) unique-block reference vector (dedup datasets), else
        None.  Same file/source precedence (and cache) as
        ``block_fingerprints`` — the publish side of the block cache slices
        a produced batch with these."""
        meta = self._block_meta(partition_id)
        return meta[1] if meta is not None else None

    def _block_meta(self, partition_id: int):
        """(fingerprints, refs) of one dedup partition, or None (classic)."""
        path = self._path(partition_id) if self.root is not None else None
        if path is not None and os.path.exists(path):
            st = os.stat(path)
            sig = (st.st_mtime_ns, st.st_size)
            with self._fp_lock:
                hit = self._blockfp_cache.get(partition_id)
            if hit is not None and hit[0] == sig:
                return hit[1]
            part = read_partition(path)  # metadata derivation: not a
            # modeled data-path read, like partition_fingerprint's file hash
            fps = columnar.block_fingerprints(part)
            meta = (
                (fps, columnar.partition_refs(part)) if fps is not None else None
            )
            with self._fp_lock:
                self._blockfp_cache[partition_id] = (sig, meta)
            return meta
        if self.source is None:
            raise FileNotFoundError(
                f"partition {partition_id}: no disk file and no synthetic source"
            )
        src = self.source
        if src.cfg.dup_factor <= 1:
            return None
        src_fp = src.fingerprint()
        refs = src.block_refs(partition_id)
        pool_ids = src.block_pool_ids(partition_id)
        if pool_ids is not None:
            fps = [
                hashlib.sha256(f"{src_fp}:pool:{int(p)}".encode())
                .hexdigest()[:16]
                for p in pool_ids
            ]
        else:
            n_unique = src.rows // src.cfg.dup_factor
            fps = [
                hashlib.sha256(f"{src_fp}:{partition_id}:{b}".encode())
                .hexdigest()[:16]
                for b in range(n_unique)
            ]
        return fps, refs

    def _path(self, pid: int) -> str:
        # deviceNN/ prefix models per-device directories of the storage array
        dev = self.owner_of(pid)
        ddir = os.path.join(self.root, f"device{dev:03d}")
        os.makedirs(ddir, exist_ok=True)
        return os.path.join(ddir, f"part{pid:06d}.rp")


class CacheSpillStore:
    """Spill tier for the preprocessed-feature cache, on the simulated devices.

    Blocks evicted from the cache's in-memory LRU tier land here: each block
    (one train-ready mini-batch, as numpy arrays) is assigned to a simulated
    storage device by key hash, mirroring ``PartitionedStore``'s per-device
    ownership.  Residency is charged to the same byte-movement cost model as
    ISP placement — every write and read accrues ``bytes / bytes_per_s``
    modeled seconds (default: the ISP unit's internal SSD->FPGA stream rate,
    ``core.costmodel.PlacementCostModel.isp_stream_bytes_per_s``), so a spill
    hit is cheaper than recompute only when the cost model says so.

    With ``root`` set, blocks live as one ``.npz`` file per block under
    per-device directories (restart-survivable); otherwise they live in
    per-device dicts (pure simulation).  Thread-safe.

    Spilled payloads are row-deduped at rest: integer arrays whose leading-
    axis rows repeat (dedup datasets' ``multi_hot_ids``/``lengths`` repeat
    every session's block) are stored as unique rows + a refs vector when
    that is strictly smaller, and the ledgers are charged only the stored
    (unique) bytes.  Reads expand back before returning — bitwise lossless,
    invisible to callers.
    """

    # key suffixes of a row-deduped spilled array (unique rows / refs);
    # batch keys never carry them
    _DD_BLOCKS = "__ddb"
    _DD_REFS = "__ddr"
    # reserved key of the block's write-time checksum (sha256 over the clean
    # stored arrays); read verifies it, so a corrupt block is detected and
    # dropped — a cache hit is never wrong, a miss only costs recompute
    _CK = "__ck"

    @classmethod
    def _checksum(cls, arrays: Dict[str, np.ndarray]) -> np.ndarray:
        """Canonical content digest of a stored block (names, dtypes,
        shapes, bytes — order-independent), as a (32,) uint8 array so it
        survives the npz round trip."""
        h = hashlib.sha256()
        for k in sorted(arrays):
            if k == cls._CK:
                continue
            a = np.ascontiguousarray(arrays[k])
            h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
        return np.frombuffer(h.digest(), dtype=np.uint8).copy()

    @classmethod
    def _dedup_rows(cls, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Row-dedup eligible arrays for storage (lossless; see class doc)."""
        out: Dict[str, np.ndarray] = {}
        for k, a in arrays.items():
            a = np.asarray(a)
            # integer-only: exact row equality, and that's where dedup
            # datasets repeat (hashed ids / lengths); float rows are noise
            if a.ndim >= 2 and a.shape[0] >= 2 and a.dtype.kind in "iub":
                flat = np.ascontiguousarray(a.reshape(a.shape[0], -1))
                uniq, inv = np.unique(flat, axis=0, return_inverse=True)
                inv = np.ascontiguousarray(inv.reshape(-1).astype(np.int32))
                if uniq.nbytes + inv.nbytes < a.nbytes:
                    out[k + cls._DD_BLOCKS] = uniq.reshape(-1, *a.shape[1:])
                    out[k + cls._DD_REFS] = inv
                    continue
            out[k] = a
        return out

    @classmethod
    def _expand_rows(cls, block: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Inverse of ``_dedup_rows``: rebuild the logical arrays (bitwise)."""
        out: Dict[str, np.ndarray] = {}
        for k, a in block.items():
            if k.endswith(cls._DD_REFS):
                continue
            if k.endswith(cls._DD_BLOCKS):
                base = k[: -len(cls._DD_BLOCKS)]
                full = a[block[base + cls._DD_REFS]]
                full.setflags(write=False)
                out[base] = full
            else:
                out[k] = a
        return out

    def __init__(
        self,
        num_devices: int = 4,
        *,
        capacity_bytes: Optional[int] = None,
        bytes_per_s: float = 8e9,
        root: Optional[str] = None,
        fleet: Optional[DeviceFleet] = None,
    ):
        if num_devices < 1:
            raise ValueError(f"num_devices={num_devices} must be >= 1")
        if fleet is not None and num_devices != len(fleet):
            raise ValueError(
                f"num_devices={num_devices} but the shared fleet has "
                f"{len(fleet)} device(s)"
            )
        self.num_devices = num_devices
        self.capacity_bytes = capacity_bytes
        self.bytes_per_s = bytes_per_s
        self.root = root
        self.fleet = fleet  # spill traffic contends on the shared ledgers
        self._devices: List[Dict[str, Dict[str, np.ndarray]]] = [
            {} for _ in range(num_devices)
        ]
        self._sizes: Dict[str, int] = {}  # key -> block bytes (insertion order)
        self._resident = 0  # running sum of _sizes values
        self._lock = threading.Lock()
        self.bytes_written = 0
        self.bytes_read = 0
        self.modeled_io_s = 0.0
        # Fault domain: `events` is the duck-typed EventLog hook (wired by
        # the service before warm_start so boot-time corruption is visible);
        # `fault_injector` corrupts blocks at rest / fails reads; corrupt
        # blocks found on read are dropped + counted here, never served.
        self.events: Any = None
        self.fault_injector: Optional[IoFaultInjector] = None
        self.corrupt_drops = 0
        # per-owning-device modeled seconds: spill residency is DEVICE work,
        # so a hot device's cache traffic shows up on ITS ledger, not a
        # global pot (the global modeled_io_s stays as the aggregate)
        self.io_s_by_device: List[float] = [0.0] * num_devices
        if root is not None:
            self._rescan()

    def owner_of(self, key: str) -> int:
        return int(hashlib.sha256(key.encode()).hexdigest()[:8], 16) % self.num_devices

    def _charge(self, key: str, nbytes: int) -> None:
        """Charge one block movement to the OWNING device (caller holds no
        lock ordering obligations: device ledgers use their own locks)."""
        dev = self.owner_of(key)
        if self.fleet is not None:
            dt = self.fleet[dev].charge_stream(nbytes, spill=True)
        else:
            dt = nbytes / self.bytes_per_s
        with self._lock:
            self.modeled_io_s += dt
            self.io_s_by_device[dev] += dt

    def keys(self) -> List[str]:
        """Resident block keys, oldest first (insertion/rescan order)."""
        with self._lock:
            return list(self._sizes)

    def _rescan(self) -> None:
        """Rebuild the residency index from blocks that survived a restart.

        Blocks live one ``.npz`` per key under per-device directories; after
        a process restart the in-memory index is empty even though the bytes
        are still on the simulated devices.  Rescanning (oldest mtime first,
        so eviction order survives too) is what makes the feature cache's
        warm start possible.  Sizes are file sizes — close enough to the
        original array bytes for capacity and charging purposes."""
        if not os.path.isdir(self.root):
            return
        found = []
        for d in range(self.num_devices):
            ddir = os.path.join(self.root, f"device{d:03d}")
            if not os.path.isdir(ddir):
                continue
            for fn in os.listdir(ddir):
                if not (fn.startswith("cache_") and fn.endswith(".npz")):
                    continue
                key = fn[len("cache_"):-len(".npz")]
                try:
                    st = os.stat(os.path.join(ddir, fn))
                except OSError:
                    continue
                found.append((st.st_mtime_ns, key, st.st_size))
        with self._lock:
            for _, key, size in sorted(found):
                if key in self._sizes:
                    continue
                self._sizes[key] = size
                self._resident += size

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident

    def __len__(self) -> int:
        with self._lock:
            return len(self._sizes)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._sizes

    def _block_path(self, key: str) -> str:
        ddir = os.path.join(self.root, f"device{self.owner_of(key):03d}")
        os.makedirs(ddir, exist_ok=True)
        return os.path.join(ddir, f"cache_{key}.npz")

    def write(self, key: str, arrays: Dict[str, np.ndarray]) -> int:
        """Spill one block; returns its size in bytes.  Oldest blocks are
        dropped when a capacity bound is set (the spill tier is a cache of a
        cache — recompute is always available underneath)."""
        def frozen(v: np.ndarray) -> np.ndarray:
            # blocks are served to many tenants: never mutable.  A read-only
            # VIEW leaves the caller's own array untouched, zero-copy.
            a = np.asarray(v)
            if a.flags.writeable:
                a = a.view()
                a.setflags(write=False)
            return a

        arrays = self._dedup_rows({k: frozen(v) for k, v in arrays.items()})
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        # checksum over the CLEAN arrays, stored alongside: survives process
        # restarts inside the npz, so warm_start rescans verify too.  An
        # injector corrupts the STORED copy only — the checksum stays
        # honest, which is exactly what lets the next read detect it.
        ck = self._checksum(arrays)
        stored = dict(arrays)
        if self.fault_injector is not None:
            stored = self.fault_injector.maybe_corrupt_spill(key, stored)
        stored[self._CK] = ck
        if self.root is not None:
            np.savez(self._block_path(key), **stored)
        dropped: List[str] = []
        with self._lock:
            if self.root is None:
                self._devices[self.owner_of(key)][key] = stored
            old_bytes = self._sizes.pop(key, None)
            if old_bytes is not None:
                self._resident -= old_bytes
            self._sizes[key] = nbytes
            self._resident += nbytes
            self.bytes_written += nbytes
            if self.capacity_bytes is not None:
                while self._resident > self.capacity_bytes and len(self._sizes) > 1:
                    old = next(iter(self._sizes))
                    if old == key:
                        break
                    self._resident -= self._sizes.pop(old)
                    self._devices[self.owner_of(old)].pop(old, None)
                    dropped.append(old)
        self._charge(key, nbytes)
        if self.root is not None:
            for old in dropped:
                try:
                    os.remove(self._block_path(old))
                except OSError:
                    pass
        return nbytes

    def read(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        """Fetch one spilled block (None if absent, unreadable, or corrupt).

        The read bytes are charged to the block's OWNING device's ledger — a
        spill hit promoted back to the memory tier is byte movement on that
        device, contending with its partition reads and ISP compute.

        Integrity: the block's stored checksum is verified before return.  A
        mismatch (or an unreadable npz — torn writes raise anything from
        ``BadZipFile`` to ``EOFError``, not just ``OSError``) drops the
        block from the index AND the device, emits a ``spill_corrupt``
        event, and reads as a miss: the feature cache recomputes cold.  A
        session never sees corrupt bytes from the spill tier, only latency.
        This is also what makes ``FeatureCache.warm_start`` safe: a corrupt
        survivor block is skipped at boot instead of aborting the service."""
        with self._lock:
            nbytes = self._sizes.get(key)
            if nbytes is None:
                return None
        inj = self.fault_injector
        if inj is not None and inj.on_spill_read(key):
            return None  # injected transient: a miss, recompute underneath
        if self.root is None:
            with self._lock:
                stored = self._devices[self.owner_of(key)].get(key)
            if stored is None:
                return None
            block = dict(stored)
        else:
            try:
                with np.load(self._block_path(key)) as z:
                    block = {k: z[k] for k in z.files}
            except FileNotFoundError:
                return None  # evicted between the size check and the load
            except Exception as e:
                self._drop_corrupt(key, f"unreadable: {e!r}")
                return None
            for a in block.values():
                a.setflags(write=False)
        ck = block.pop(self._CK, None)
        if ck is None or not np.array_equal(
            self._checksum(block), np.asarray(ck)
        ):
            self._drop_corrupt(
                key, "checksum missing" if ck is None else "checksum mismatch"
            )
            return None
        with self._lock:
            self.bytes_read += nbytes
        self._charge(key, nbytes)
        return self._expand_rows(block)

    def _drop_corrupt(self, key: str, reason: str) -> None:
        """Evict a block that failed integrity on read.  The spill tier is
        a cache of a cache — recompute is always available underneath, so
        dropping is always safe; the event makes the damage observable."""
        dev = self.owner_of(key)
        with self._lock:
            nbytes = self._sizes.pop(key, None)
            if nbytes is not None:
                self._resident -= nbytes
            self._devices[dev].pop(key, None)
            self.corrupt_drops += 1
        if self.root is not None:
            try:
                os.remove(self._block_path(key))
            except OSError:
                pass
        ev = self.events
        if ev is not None:
            try:
                ev.emit("spill_corrupt", key=key, device=dev, reason=reason)
            except Exception:
                pass  # a broken observer never breaks the read path
