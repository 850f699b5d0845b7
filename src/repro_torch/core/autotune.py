"""Online megabatch-K autotuning for the zero-stall produce path.

The port's own copy of ``repro.core.autotune``: the same ladder and the same
hill climb, so one cost sequence gives the same K trajectory in both
packages.

The zero-stall pipeline made the produce hot path megabatched (K claims,
one kernel dispatch) and double-buffered, but K itself stayed a static
per-``JobSpec`` knob.  The right K is workload-dependent: the dispatch
overhead a megabatch amortizes is fixed, while the per-partition produce
time moves with the operator mix, partition geometry, and device
contention — so a K hand-picked on one shape reintroduces launch stalls
(K too small) or delivery latency and staging bulk (K too large) on
another.  Meta's production preprocessing service (DPP) re-tunes itself
continuously for exactly this reason; this module is that loop for the
simulated ISP pool.

``MegabatchTuner`` makes the choice online and *measured*:

* It is seeded from the cost model's predicted optimum
  (``core.costmodel.PlacementCostModel.predicted_megabatch_k`` — the knee
  of the modeled ``megabatch_amortization`` curve), so the first launches
  already run near the right rung.
* Every launch reports its overlap-corrected wall seconds (the same
  ``produce_time_s`` share accounting the pipelined worker loop records);
  the tuner hill-climbs the measured per-partition cost ``launch_s / K``
  over a power-of-two ladder — one rung at a time, ``min_samples``
  launches per rung, moving only on a strict relative improvement — and
  provably stops moving: exploration visits each rung at most once, and
  improvement moves are hard-capped by ``max_moves``.
* K values are restricted to the ladder so the jit shape cache compiles
  O(log K_max) megabatch shapes, not one per arbitrary K.

``core.service.Session`` owns one tuner per autotuned session and feeds
the chosen K back into the planner's per-worker P estimate
(``Session._on_tuned_k_changed``): a K move re-bases P from the new
rung's measured cost and re-plans the pool — the same lazy re-plan
trigger the feature-cache hit-rate discount uses — so unit shares
re-balance as K converges.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

__all__ = ["DEFAULT_AUTOTUNE_KMAX", "MegabatchTuner", "k_ladder"]

DEFAULT_AUTOTUNE_KMAX = 8  # K cap when a JobSpec enables autotune without one


def k_ladder(k_max: int) -> List[int]:
    """Power-of-two megabatch candidates in [1, k_max].

    Every rung is a distinct compiled (K, rows) shape; a power-of-two
    ladder bounds the jit shape cache at O(log K_max) megabatch programs
    while keeping neighboring rungs a constant factor apart (so "within
    one step of the best static K" is a meaningful convergence bound).
    """
    k_max = max(1, int(k_max))
    ks = [1]
    while ks[-1] * 2 <= k_max:
        ks.append(ks[-1] * 2)
    return ks


@dataclasses.dataclass
class _Arm:
    """Measured state of one ladder rung."""

    cost_s: Optional[float] = None  # EMA per-partition seconds at this K
    samples: int = 0


class MegabatchTuner:
    """Hill-climbs megabatch K from measured per-launch seconds.

    Thread-safe (pool workers of one session record concurrently).  The
    proposal ``k`` is the K the session should coalesce for its NEXT
    launch; ``record(k, launch_s)`` feeds one finished launch back and
    returns True when the proposal moved (the session then re-bases its
    planner P estimate).  Launches whose actual K is off the proposal —
    tail chunks, backpressure truncations — still update that rung's EMA
    when it exists but never advance the climb, so partial chunks cannot
    steer the tuner off measured ground.
    """

    def __init__(
        self,
        k_max: int = DEFAULT_AUTOTUNE_KMAX,
        *,
        per_partition_s: Optional[float] = None,
        cost_model=None,
        min_samples: int = 2,
        rel_tolerance: float = 0.05,
        ema: float = 0.5,
        max_moves: Optional[int] = None,
    ):
        self.ladder = k_ladder(k_max)
        self.min_samples = max(1, int(min_samples))
        self.rel_tolerance = float(rel_tolerance)
        self.ema = float(ema)
        self._arms: Dict[int, _Arm] = {k: _Arm() for k in self.ladder}
        self._lock = threading.Lock()
        self._moves = 0
        self._max_moves = (
            2 * len(self.ladder) if max_moves is None else max(0, int(max_moves))
        )
        self._converged = len(self.ladder) == 1
        seed = 1
        if per_partition_s is not None and per_partition_s > 0:
            if cost_model is None:
                from repro_torch.core.costmodel import DEFAULT_PLACEMENT_MODEL

                cost_model = DEFAULT_PLACEMENT_MODEL
            seed = cost_model.predicted_megabatch_k(
                per_partition_s,
                self.ladder[-1],
                rel_tolerance=self.rel_tolerance,
                candidates=self.ladder,
            )
        self.seeded_k = seed if seed in self.ladder else 1
        self._idx = self.ladder.index(self.seeded_k)

    @property
    def k(self) -> int:
        """The K the session should coalesce for its next launch."""
        with self._lock:
            return self.ladder[self._idx]

    @property
    def converged(self) -> bool:
        with self._lock:
            return self._converged

    @property
    def moves(self) -> int:
        with self._lock:
            return self._moves

    def arm_cost(self, k: int) -> Optional[float]:
        """Measured EMA per-partition seconds at rung `k`, or None."""
        with self._lock:
            arm = self._arms.get(int(k))
            return arm.cost_s if arm is not None and arm.samples else None

    def record(self, k: int, launch_s: float) -> bool:
        """Feed one finished launch of `k` partitions taking `launch_s`
        overlap-corrected seconds.  Returns True when the proposal K
        changed (explore step or improvement move); after convergence the
        proposal never changes again, only EMAs keep tracking."""
        k = int(k)
        if k <= 0 or launch_s <= 0.0:
            return False
        with self._lock:
            arm = self._arms.get(k)
            if arm is None:
                return False  # off-ladder partial chunk: no rung to credit
            cost = launch_s / k
            arm.cost_s = (
                cost
                if arm.cost_s is None
                else self.ema * arm.cost_s + (1.0 - self.ema) * cost
            )
            arm.samples += 1
            if self._converged:
                return False
            if k != self.ladder[self._idx]:
                return False  # partial/foreign launch never advances the climb
            if arm.samples < self.min_samples:
                return False
            return self._advance()

    def _advance(self) -> bool:
        """One climb step, current rung fully measured.  Caller holds the
        lock.  Order of play: (1) a measured neighbor strictly better than
        the current rung (beyond the tolerance) wins an improvement move;
        (2) otherwise the current rung is locally best among measured
        rungs, so explore an unmeasured neighbor — uphill first, because
        the modeled amortization curve improves with K until it plateaus;
        (3) nothing left to try: converge, permanently."""
        n = len(self.ladder)

        def cost(j: int) -> float:
            return self._arms[self.ladder[j]].cost_s

        def measured(j: int) -> bool:
            return 0 <= j < n and self._arms[self.ladder[j]].samples >= self.min_samples

        best = self._idx
        for j in (self._idx - 1, self._idx + 1):
            if measured(j) and cost(j) < cost(best) * (1.0 - self.rel_tolerance):
                best = j
        if best != self._idx:
            if self._moves >= self._max_moves:
                self._converged = True  # oscillation backstop: freeze here
                return False
            self._moves += 1
            self._idx = best
            return True
        for j in (self._idx + 1, self._idx - 1):
            if 0 <= j < n and not measured(j):
                self._idx = j
                return True
        self._converged = True
        return False

    def restore(self, state: dict) -> None:
        """Re-seed from a checkpointed ``summary()`` dict (the control
        plane's session resume path): measured per-rung EMAs, the move
        count, convergence, and the proposal rung all carry over, so a
        resumed session of the same Transform starts at its converged K
        instead of re-climbing.  Off-ladder rungs in the snapshot (a
        different ``k_max``) are ignored; JSON round-trips stringify arm
        keys, so keys are coerced back to ints."""
        with self._lock:
            for key, arm in (state.get("arms") or {}).items():
                k = int(key)
                ours = self._arms.get(k)
                if ours is None or not arm.get("samples"):
                    continue
                ours.cost_s = arm.get("cost_s")
                ours.samples = int(arm["samples"])
            k = int(state.get("k", self.ladder[self._idx]))
            if k in self.ladder:
                self._idx = self.ladder.index(k)
            self._moves = int(state.get("moves", self._moves))
            self._converged = (
                bool(state.get("converged", self._converged))
                or len(self.ladder) == 1
            )

    def summary(self) -> dict:
        """Point-in-time view for stats tables and bench artifacts."""
        with self._lock:
            return {
                "k": self.ladder[self._idx],
                "seeded_k": self.seeded_k,
                "converged": self._converged,
                "moves": self._moves,
                "arms": {
                    k: {"cost_s": a.cost_s, "samples": a.samples}
                    for k, a in self._arms.items()
                    if a.samples
                },
            }
