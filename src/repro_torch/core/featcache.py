"""Content-addressed cache of preprocessed (train-ready) mini-batches.

The port's own copy of ``repro.core.featcache``.  The memory tier holds a
batch as produced — tensors on the card — so an in-memory hit never leaves
the device; a batch crosses to the host once, when it spills, and a spill
hit is copied back to the cache's device as it is promoted.  Sizes count
each tensor's ``numel() * element_size()``.  The block tier holds numpy
blocks (``TorchPreStoEngine.extract_blocks`` crosses them to the host once).
Keys carry the port's ``cache_signature``, whose ``"torch"`` tag keeps the
port's entries apart from the JAX package's.

Production RecSys training re-preprocesses the *same* samples across jobs
constantly (RecD; Meta's ingestion characterization) — so once PreSto runs as
a multi-tenant service over one shared ISP pool, the highest-leverage saving
left is to not recompute a mini-batch any tenant already produced.  This
module is that saving:

* ``CacheKey`` — content addressing.  A batch is identified by what went in
  and what was done to it: the *partition fingerprint*
  (``data.storage.PartitionedStore.partition_fingerprint`` — equal encoded
  bytes ⇒ equal fingerprint, across store objects and tenants), the
  *lowered-opgraph hash* (``core.opgraph.LoweredPlan.structural_hash`` —
  stable across re-lowering), and the *placement* signature.  Because
  preprocessing is deterministic in the key, a hit is bitwise identical to a
  cold compute, which preserves the service's bitwise-identity guarantee
  (``tests/test_service.py``).

* ``FeatureCache`` — two tiers.  A bounded-memory LRU tier holds hot batches;
  on eviction a batch spills (optionally) to
  ``data.storage.CacheSpillStore``, which parks blocks on the simulated
  storage devices and charges every byte moved to the same cost model as ISP
  placement (``isp_stream_bytes_per_s``).  A spill hit is promoted back into
  the LRU tier.  Misses fall through to recompute.

* In-flight dedup.  Concurrent tenants racing to the same cold key would
  both miss and both produce; ``begin``/``fulfill`` close that window — the
  first prober becomes the *leader* (it produces), later probers *follow*
  (their claims resolve from the leader's in-flight future, no produce).

Wiring (see ``core.service``): the shared ``PreprocessingService`` owns ONE
``FeatureCache``; each session probes it at claim time
(``data.loader.SessionQueue`` short-circuits cached claims so pool workers
never spend a produce on a hit), winners populate it, and
``core.planner.plan_pool`` discounts a job's ceil(T/P) demand by its observed
hit rate so units freed by hits rebalance to cold jobs.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.util import resolve_device
from repro_torch.data.storage import CacheSpillStore

__all__ = [
    "BlockKey",
    "CacheKey",
    "CacheStats",
    "FeatureCache",
    "default_spill_store",
]


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """Content address of one preprocessed mini-batch."""

    partition_fp: str  # PartitionedStore.partition_fingerprint(pid)
    plan_hash: str  # LoweredPlan.structural_hash() of the lowered Transform
    placement: str  # engine placement (the signature carries the backend tag)

    def block_id(self) -> str:
        """Flat id used by the spill tier's per-device block files."""
        return f"{self.partition_fp}-{self.plan_hash}-{self.placement}"


@dataclasses.dataclass(frozen=True)
class BlockKey:
    """Content address of ONE hashed sparse block (dedup datasets).

    Sample-level dedup (RecD) shares sparse-feature blocks across sessions,
    partitions and tenants; the per-partition ``CacheKey`` cannot see that
    overlap.  A ``BlockKey`` addresses the train-ready form of one unique
    block — its SigridHashed ids + lengths — by the block's content
    fingerprint (``data.storage.PartitionedStore.block_fingerprints``) plus
    the same plan/placement components as ``CacheKey``, so two tenants whose
    partitions merely SHARE blocks (same session pool, different pids) reuse
    each other's hashed blocks at block granularity."""

    block_fp: str  # PartitionedStore.block_fingerprints(pid)[b]
    plan_hash: str  # LoweredPlan.structural_hash() of the lowered Transform
    placement: str  # engine placement signature (comm placement included)


@dataclasses.dataclass
class CacheStats:
    """Point-in-time accounting for one FeatureCache."""

    hits: int = 0  # total hits (memory tier + spill tier)
    spill_hits: int = 0  # hits served by the spill tier (subset of hits)
    follows: int = 0  # probes that joined a leader's in-flight produce
    misses: int = 0
    # predictive pre-warm probes (issued AHEAD of the claim cursor by the
    # service's peek-window walker); tallied apart from hits/misses so
    # hit_rate keeps meaning "fraction of CLAIMS needing no produce" — the
    # claim that later lands on a pre-warmed key still counts itself
    prewarm_hits: int = 0  # pre-warm probes that found the content cached
    prewarm_leases: int = 0  # pre-warm probes that took a produce lease
    insertions: int = 0
    evictions: int = 0  # LRU-tier evictions (spilled or dropped)
    entries: int = 0  # LRU-tier entries right now
    resident_bytes: int = 0  # LRU-tier bytes right now
    spilled_entries: int = 0
    spilled_bytes: int = 0
    bytes_served: int = 0  # batch bytes returned by hits
    # block tier (dedup datasets): hashed sparse blocks shared across
    # partitions/tenants at block granularity
    block_hits: int = 0
    block_misses: int = 0
    block_insertions: int = 0
    block_entries: int = 0
    block_resident_bytes: int = 0
    spill_io_s: float = 0.0  # modeled seconds of spill-tier byte movement
    # device -> modeled seconds: spill residency is charged to each block's
    # OWNING simulated device, not a global pot
    spill_io_s_by_device: Dict[int, float] = dataclasses.field(default_factory=dict)
    warm_started: int = 0  # blocks promoted into the LRU tier at boot

    @property
    def probes(self) -> int:
        return self.hits + self.follows + self.misses

    @property
    def hit_rate(self) -> float:
        """Fraction of probes that needed no produce (hits + follows)."""
        return (self.hits + self.follows) / self.probes if self.probes else 0.0


def default_spill_store(
    num_devices: int = 4,
    *,
    capacity_bytes: Optional[int] = None,
    root: Optional[str] = None,
    model=None,
    fleet=None,
) -> CacheSpillStore:
    """A spill tier charged at the ISP placement cost model's stream rate —
    cache residency moves bytes on the same simulated devices, priced the
    same way as the ISP units' own SSD->FPGA streams.  Pass the service's
    shared ``data.storage.DeviceFleet`` so spill traffic lands on the same
    per-device ledgers partition reads and ISP compute charge."""
    from repro_torch.core.costmodel import DEFAULT_PLACEMENT_MODEL  # lazy: no cycle

    model = model or DEFAULT_PLACEMENT_MODEL
    return CacheSpillStore(
        num_devices,
        capacity_bytes=capacity_bytes,
        bytes_per_s=model.isp_stream_bytes_per_s,
        root=root,
        fleet=fleet,
    )


def _nbytes(v: Any) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(np.asarray(v).nbytes)


def batch_nbytes(batch: Any) -> int:
    """Size in bytes of one train-ready mini-batch (dict of tensors or
    arrays), wherever its tensors live; 0 for an object that is not one."""
    try:
        return sum(_nbytes(v) for v in batch.values())
    except (AttributeError, TypeError, ValueError):
        return 0


def _numpy(v: Any) -> np.ndarray:
    """One array on the host (a device tensor is copied once)."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _host(batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A batch's arrays on the host, for the spill tier."""
    return {k: _numpy(v) for k, v in batch.items()}


class FeatureCache:
    """Bounded-memory LRU of train-ready batches, with an optional spill tier.

    Thread-safe; shared by every session of a ``PreprocessingService``.
    Sessions use ``begin``/``fulfill``/``abandon`` (claim-time probe with
    in-flight dedup); ``get``/``put``/``peek`` are the tier primitives.  The
    batch object is stored as produced (and spilled/restored as numpy), so a
    hit returns values bitwise identical to the cold compute that populated
    it.  Spilled batches come back as tensors on ``device`` (CUDA unless the
    caller names another).
    """

    def __init__(
        self,
        capacity_bytes: int = 256 << 20,
        *,
        spill: Optional[CacheSpillStore] = None,
        block_capacity_bytes: Optional[int] = None,
        device: torch.device | str | None = None,
    ):
        if capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes={capacity_bytes} must be > 0")
        self.capacity_bytes = capacity_bytes
        self.spill = spill
        self.device = resolve_device(device)
        self._lru: "OrderedDict[CacheKey, Tuple[Any, int]]" = OrderedDict()
        self._resident = 0
        # block tier: hashed sparse blocks of dedup datasets, its own small
        # LRU (memory-only — blocks are tiny next to batches and recompute
        # is one fused launch away)
        self.block_capacity_bytes = (
            block_capacity_bytes
            if block_capacity_bytes is not None
            else capacity_bytes // 4
        )
        self._blocks: "OrderedDict[BlockKey, Tuple[Any, int]]" = OrderedDict()
        self._block_resident = 0
        self._block_hits = 0
        self._block_misses = 0
        self._block_insertions = 0
        self._inflight: Dict[CacheKey, Future] = {}  # leader produces
        self._lock = threading.Lock()
        self._hits = 0
        self._spill_hits = 0
        self._follows = 0
        self._misses = 0
        self._prewarm_hits = 0
        self._prewarm_leases = 0
        self._insertions = 0
        self._evictions = 0
        self._bytes_served = 0
        self._warm_started = 0
        self._warmed = False

    def warm_start(self) -> int:
        """Rebuild the LRU index from the spill tier's restart-survivable
        blocks (newest first, up to the memory bound).

        After a service restart the spill tier rescans its ``.npz`` blocks
        from disk, but the memory tier starts cold; promoting the freshest
        blocks back at boot means a restarted service serves bitwise-
        identical hits without a single recompute.  Blocks past the memory
        bound stay spilled — they still hit through the spill tier.  The
        promotion I/O is real modeled byte movement (charged to each
        block's owning device).  Idempotent per cache; returns the number
        of blocks promoted."""
        if self._warmed or self.spill is None or self.spill.root is None:
            return 0
        self._warmed = True
        picked = []  # newest-first selection, bounded by the memory tier
        budget = self.capacity_bytes
        for block_id in reversed(self.spill.keys()):
            parts = block_id.split("-", 2)
            if len(parts) != 3:
                continue  # foreign file in the spill root: not ours
            key = CacheKey(*parts)
            with self._lock:
                if key in self._lru:
                    continue
            block = self._restore(self.spill.read(block_id))
            if block is None:
                continue
            nbytes = batch_nbytes(block)
            if nbytes <= 0 or nbytes > budget:
                break  # memory tier full: the rest stays spilled (hit-able)
            budget -= nbytes
            picked.append((key, block))
        # insert OLDEST first so LRU recency matches block age: the newest
        # block ends most-recently-used, never the first eviction victim
        for key, block in reversed(picked):
            self.put(key, block)
        with self._lock:
            self._warm_started = len(picked)
        return len(picked)

    def flush_spill(self) -> int:
        """Write every memory-tier entry through to a ROOTED spill tier (the
        restart checkpoint ``warm_start`` rebuilds from).  Content-addressed,
        so blocks already spilled are skipped; returns blocks written.  The
        service calls this on ``close()`` so a graceful shutdown leaves the
        whole cache restart-survivable, not just the evicted part."""
        if self.spill is None or self.spill.root is None:
            return 0
        with self._lock:
            entries = [(k, b) for k, (b, _n) in self._lru.items()]
        written = 0
        for key, batch in entries:
            block_id = key.block_id()
            if block_id in self.spill:
                continue
            self.spill.write(block_id, _host(batch))
            written += 1
        return written

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def _lookup(self, key: CacheKey, *, record: bool) -> Optional[Any]:
        """Probe both tiers.  Tier effects (LRU recency, spill promotion)
        always happen; hit accounting only when ``record`` — pre-warm probes
        want the promotion without inflating the claim-path hit stats."""
        with self._lock:
            entry = self._lru.get(key)
            if entry is not None:
                self._lru.move_to_end(key)
                if record:
                    self._hits += 1
                    self._bytes_served += entry[1]
                # shallow copy: consumers may mutate their batch dict; the
                # tensors are shared, and consumers must not write to them
                return dict(entry[0])
        if self.spill is not None:
            block = self._restore(self.spill.read(key.block_id()))
            if block is not None:
                with self._lock:
                    if record:
                        self._hits += 1
                        self._spill_hits += 1
                        self._bytes_served += batch_nbytes(block)
                self.put(key, block)  # promote (insertion counted as such)
                return block
        return None

    def peek(self, key: CacheKey) -> Optional[Any]:
        """Probe both tiers, counting a hit but never a miss (used by
        straggler re-issues, which must fall through to a real produce
        rather than follow the possibly-stuck in-flight leader)."""
        return self._lookup(key, record=True)

    def get(self, key: CacheKey) -> Optional[Any]:
        """The batch for `key`, or None.  Hits refresh LRU recency; spill
        hits are promoted back into the memory tier."""
        batch = self.peek(key)
        if batch is None:
            with self._lock:
                self._misses += 1
        return batch

    def begin(self, key: CacheKey, *, prewarm: bool = False) -> Tuple[str, Any]:
        """Claim-time probe with in-flight dedup.  Returns one of

        * ``("hit", batch)``     — cached; use the batch, no produce.
        * ``("follow", future)`` — another tenant is producing this exact
          batch right now; resolve from its future, no produce.
        * ``("produce", None)``  — the caller is the leader: produce, then
          ``fulfill`` (or ``abandon`` on error) so followers resolve.

        ``prewarm=True`` marks a predictive probe issued AHEAD of the claim
        cursor (the service's peek-window pre-warmer).  Tier effects are
        identical — a spill hit is promoted so the upcoming claim lands in
        the memory tier, and a cold key takes the leader lease so
        concurrent tenants follow instead of duplicating the produce — but
        the probe is tallied under ``prewarm_hits``/``prewarm_leases``
        instead of hits/follows/misses, keeping ``hit_rate`` a claim-path
        statistic (the claim that follows the pre-warm counts itself).
        """
        batch = self._lookup(key, record=not prewarm)
        if batch is not None:
            if prewarm:
                with self._lock:
                    self._prewarm_hits += 1
            return "hit", batch
        with self._lock:
            fut = self._inflight.get(key)
            if fut is not None:
                if not prewarm:
                    self._follows += 1
                return "follow", fut
            self._inflight[key] = Future()
            if prewarm:
                self._prewarm_leases += 1
            else:
                self._misses += 1
            return "produce", None

    def fulfill(self, key: CacheKey, batch: Any) -> None:
        """A produce of `key` completed: insert and resolve any followers."""
        self.put(key, batch)
        with self._lock:
            fut = self._inflight.pop(key, None)
        if fut is not None:
            fut.set_result(batch)

    def abandon(self, key: CacheKey, exc: Optional[BaseException] = None) -> None:
        """The leader's produce failed (or was dropped): unblock followers.

        With `exc`, followers see the error (preprocessing is deterministic
        in the key, so their own produce would fail identically); without,
        the future is cancelled and followers' straggler machinery re-issues
        a real produce."""
        with self._lock:
            fut = self._inflight.pop(key, None)
        if fut is None:
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.cancel()

    def put(self, key: CacheKey, batch: Any) -> None:
        """Insert (idempotent — concurrent winners of the same key collapse
        to one entry), evicting LRU entries past the memory bound."""
        nbytes = batch_nbytes(batch)
        if nbytes <= 0 or nbytes > self.capacity_bytes:
            return  # unsized or oversized batches are not cacheable
        batch = dict(batch)  # detach from the producer's mutable dict
        evicted = []
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self._resident -= old[1]
            self._lru[key] = (batch, nbytes)
            self._resident += nbytes
            self._insertions += 1
            while self._resident > self.capacity_bytes and len(self._lru) > 1:
                old_key, (old_batch, old_bytes) = self._lru.popitem(last=False)
                self._resident -= old_bytes
                self._evictions += 1
                evicted.append((old_key, old_batch))
        if self.spill is not None:
            for old_key, old_batch in evicted:
                block_id = old_key.block_id()
                if block_id in self.spill:
                    continue  # content-addressed: the spilled copy (kept on
                    # promote) is already byte-identical — skip the rewrite
                self.spill.write(block_id, _host(old_batch))

    def _restore(self, block: Optional[Dict[str, np.ndarray]]) -> Optional[Dict[str, torch.Tensor]]:
        """A spilled block's arrays as tensors on the cache's device."""
        if block is None:
            return None
        return {k: torch.from_numpy(np.array(v)).to(self.device) for k, v in block.items()}

    # -- block tier (dedup datasets) ----------------------------------------

    def put_block(self, key: BlockKey, ids: np.ndarray, lens: np.ndarray) -> None:
        """Insert one hashed sparse block: ``(ids (S, L) i32, lens (S,) i32)``.

        Idempotent by content address; evicts LRU blocks past the block
        tier's own byte bound.  Publishers pass slices of a produced batch
        (``TorchPreStoEngine.extract_blocks``)."""
        ids = _numpy(ids)
        lens = _numpy(lens)
        nbytes = int(ids.nbytes) + int(lens.nbytes)
        if nbytes <= 0 or nbytes > self.block_capacity_bytes:
            return
        with self._lock:
            old = self._blocks.pop(key, None)
            if old is not None:
                self._block_resident -= old[1]
            self._blocks[key] = ((ids, lens), nbytes)
            self._block_resident += nbytes
            self._block_insertions += 1
            while (
                self._block_resident > self.block_capacity_bytes
                and len(self._blocks) > 1
            ):
                _, (_b, old_bytes) = self._blocks.popitem(last=False)
                self._block_resident -= old_bytes

    def get_block(self, key: BlockKey) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """One cached block's ``(ids, lens)``, or None.  Refreshes recency."""
        with self._lock:
            entry = self._blocks.get(key)
            if entry is None:
                self._block_misses += 1
                return None
            self._blocks.move_to_end(key)
            self._block_hits += 1
            return entry[0]

    def get_blocks(
        self, keys
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """All-or-nothing probe of a partition's block set.

        Full coverage returns the STACKED ``(ids (u, S, L), lens (u, S))``
        ready for ``TorchPreStoEngine.assemble_from_blocks``; any absent block
        returns None (the partition cold-produces, then publishes).  Counts
        one block hit/miss per key."""
        keys = list(keys)
        out = []
        with self._lock:
            missing = [k for k in keys if k not in self._blocks]
            if missing:
                self._block_misses += len(missing)
                self._block_hits += len(keys) - len(missing)
                return None
            for k in keys:
                self._blocks.move_to_end(k)
                out.append(self._blocks[k][0])
            self._block_hits += len(keys)
        ids = np.stack([b[0] for b in out])
        lens = np.stack([b[1] for b in out])
        return ids, lens

    def stats(self) -> CacheStats:
        with self._lock:
            stats = CacheStats(
                hits=self._hits,
                spill_hits=self._spill_hits,
                follows=self._follows,
                misses=self._misses,
                prewarm_hits=self._prewarm_hits,
                prewarm_leases=self._prewarm_leases,
                insertions=self._insertions,
                evictions=self._evictions,
                entries=len(self._lru),
                resident_bytes=self._resident,
                bytes_served=self._bytes_served,
                block_hits=self._block_hits,
                block_misses=self._block_misses,
                block_insertions=self._block_insertions,
                block_entries=len(self._blocks),
                block_resident_bytes=self._block_resident,
                warm_started=self._warm_started,
            )
        if self.spill is not None:
            stats.spilled_entries = len(self.spill)
            stats.spilled_bytes = self.spill.resident_bytes
            stats.spill_io_s = self.spill.modeled_io_s
            stats.spill_io_s_by_device = {
                d: s for d, s in enumerate(self.spill.io_s_by_device) if s > 0.0
            }
        return stats
