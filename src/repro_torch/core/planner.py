"""T/P provisioning planner (paper §IV-B, software steps 2-3).

The port's own copy of ``repro.core.planner``; ``measure_throughput`` waits
for a step's CUDA outputs on their devices where the reference waits with
``block_until_ready``.

The train manager stress-tests the accelerator's max training throughput T
(samples/s) with dummy mini-batches; the preprocess manager measures a single
preprocessing worker's throughput P; the job is provisioned ceil(T/P)
preprocessing workers so the trainer never starves.

With the operator-graph lowering, a job's Transform may span several
*placement groups* (ISP units vs host workers in hybrid placement); each
group is provisioned independently from its own measured group throughput
(``PlacementProvisioning``) — ISP units and CPU workers are separate
resources, so ceil(T/P) applies per group.

At the service level (``core.service``) many jobs share ONE provisioned
pool: ``plan_pool`` performs admission control (every job is guaranteed one
unit or is rejected) and splits the pool's units across jobs proportionally
to their ceil(T/P) demands, re-planned whenever jobs join, leave, or
re-estimate P.  A job's demand is discounted by its observed feature-cache
hit rate (``effective_demand_units``): batches served by the shared
``core.featcache.FeatureCache`` need no produce units, so hot jobs free
capacity that rebalances to cold ones.

Units are not fungible: each pool worker models an ISP unit bound to one
storage device.  Passing a ``DeviceTopology`` (and per-job device weights —
the fraction of each job's partitions every device owns) makes ``plan_pool``
additionally provision PER DEVICE (``PoolPlan.device_shares``), so a job
whose partitions concentrate on a hot device cannot starve another job's
units on a cold one.

Also reproduces the paper's *CPU-baseline* provisioning (Fig. 4): cores
required = T / per-core-throughput, using per-RM per-core throughputs derived
from the paper's published breakdown.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import torch


@dataclasses.dataclass
class ThroughputMeasurement:
    samples_per_s: float
    iters: int
    wall_s: float


@dataclasses.dataclass
class ProvisioningPlan:
    train_throughput: float  # T (samples/s)
    worker_throughput: float  # P (samples/s per preprocessing worker)
    workers_required: int  # ceil(T/P)

    @staticmethod
    def derive(T: float, P: float) -> "ProvisioningPlan":
        return ProvisioningPlan(T, P, max(1, math.ceil(T / P)))


@dataclasses.dataclass
class PlacementProvisioning:
    """Per-placement-group provisioning for one job (hybrid-aware T/P)."""

    train_throughput: float  # T (samples/s)
    group_throughput: Dict[str, float]  # group -> P (samples/s per unit)
    group_units: Dict[str, int]  # group -> ceil(T/P)

    @staticmethod
    def derive(T: float, group_P: Dict[str, float]) -> "PlacementProvisioning":
        return PlacementProvisioning(
            T,
            dict(group_P),
            {g: max(1, math.ceil(T / P)) for g, P in group_P.items()},
        )

    @property
    def total_units(self) -> int:
        return sum(self.group_units.values())


class AdmissionError(RuntimeError):
    """The shared pool cannot guarantee the 1-unit QoS floor for a new job."""


# -- QoS classes (the Meta DSI combo-job-peak regime) --------------------------
# Release-candidate jobs are the revenue-bearing tier: they may preempt
# exploratory capacity.  Exploratory jobs absorb contention: they are
# degraded to the 1-unit floor first and rejected first when floors no
# longer fit.  Lower rank = higher priority.
QOS_RELEASE_CANDIDATE = "rc"
QOS_EXPLORATORY = "exploratory"
QOS_RANK = {QOS_RELEASE_CANDIDATE: 0, QOS_EXPLORATORY: 1}


@dataclasses.dataclass(frozen=True)
class SloRequest:
    """One job's admission request: demand plus its QoS contract."""

    name: str
    demand_units: int
    qos_class: str = QOS_EXPLORATORY
    deadline_s: Optional[float] = None  # relative to the job's arrival

    @property
    def rank(self) -> int:
        return QOS_RANK.get(self.qos_class, max(QOS_RANK.values()) + 1)


@dataclasses.dataclass(frozen=True)
class SloDecision:
    """Per-job admission outcome: never silent starvation.

    ``admitted``  — granted its full (hit-rate-discounted) demand.
    ``degraded``  — admitted below demand (down to the 1-unit floor) because
                    higher-priority demand or aggregate contention took the
                    surplus; the job runs, slower, and the caller can tell.
    ``rejected``  — even the 1-unit floor does not fit (or a release-
                    candidate preempted this job's floor): the job is turned
                    away NOW instead of being admitted into starvation.
    """

    name: str
    status: str
    granted_units: int
    qos_class: str
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """Which pool units are bound to which simulated ISP device.

    The pool is not a fungible bag of workers: each unit is an ISP unit
    bound to ONE storage device (`data.storage.IspDevice`), so provisioning
    must be computed per device — a device's units can only serve partitions
    resident there (or host-fallback work).  ``round_robin`` is the default
    binding the service uses: worker i -> device i % num_devices.
    """

    units_per_device: Dict[int, int]

    @staticmethod
    def round_robin(num_units: int, num_devices: int) -> "DeviceTopology":
        upd = {d: 0 for d in range(num_devices)}
        for i in range(num_units):
            upd[i % num_devices] += 1
        return DeviceTopology(upd)

    @property
    def total_units(self) -> int:
        return sum(self.units_per_device.values())

    @property
    def manned(self) -> set:
        """Devices with at least one bound unit.  Partitions owned by an
        unmanned device have no local ISP unit at all — they are always
        host-fallback eligible."""
        return {d for d, u in self.units_per_device.items() if u > 0}


def _largest_remainder(units: int, weights: Dict[str, float]) -> Dict[str, int]:
    """Split `units` across keys proportionally to non-negative weights."""
    total = sum(weights.values())
    if units <= 0 or total <= 0:
        return {j: 0 for j in weights}
    quotas = {j: units * w / total for j, w in weights.items()}
    out = {j: math.floor(q) for j, q in quotas.items()}
    left = units - sum(out.values())
    for j in sorted(weights, key=lambda j: quotas[j] - out[j], reverse=True):
        if left <= 0:
            break
        out[j] += 1
        left -= 1
    return out


@dataclasses.dataclass
class PoolPlan:
    """Unit allocation of one shared worker/ISP pool across admitted jobs.

    ``demand_units`` is each job's ceil(T/P) requirement (or an explicit
    hint); ``shares`` is what the pool actually grants: every admitted job is
    guaranteed one unit (the admission floor), and surplus capacity is split
    proportionally to residual demand, never exceeding a job's demand.

    With a ``DeviceTopology``, ``device_shares`` additionally splits each
    device's bound units across jobs proportionally to each job's demand ON
    THAT DEVICE (its effective demand weighted by the fraction of its
    partitions the device owns) — so a job whose partitions all sit on a hot
    device cannot starve another job's units on a cold one.
    """

    capacity: int
    demand_units: Dict[str, int]
    shares: Dict[str, int]
    effective_demand: Optional[Dict[str, int]] = None  # after hit-rate discount
    device_shares: Optional[Dict[int, Dict[str, int]]] = None  # device -> job -> units

    @property
    def oversubscribed(self) -> bool:
        """True when aggregate demand exceeds the pool — jobs run degraded."""
        demands = self.effective_demand or self.demand_units
        return sum(demands.values()) > self.capacity

    def device_utilized_units(self, device: int) -> int:
        return sum((self.device_shares or {}).get(device, {}).values())


def qos_demand_units(
    target_samples_per_s: float, worker_samples_per_s: float, *, cap: int = 64
) -> int:
    """ceil(T/P) with the 1-unit floor and a sanity cap: the demand a QoS
    job re-estimates whenever its measured per-worker P moves — on produce
    completions (``core.service.Session._on_produced``) and on tuned
    megabatch-K shifts (``Session._on_tuned_k_changed``), both of which
    funnel through the same re-plan trigger as the hit-rate discount."""
    if not worker_samples_per_s or worker_samples_per_s <= 0:
        return 1
    return max(
        1, min(int(cap), math.ceil(target_samples_per_s / worker_samples_per_s))
    )


def effective_demand_units(demand: int, hit_rate: float) -> int:
    """ceil(T/P) demand discounted by the job's observed feature-cache hit
    rate: a fraction `hit_rate` of the job's partitions arrive without a
    produce, so the units needed to keep its trainer fed shrink by the same
    fraction (never below the 1-unit QoS floor)."""
    rate = min(max(hit_rate, 0.0), 1.0)
    return max(1, math.ceil(max(1, int(demand)) * (1.0 - rate)))


def plan_pool(
    capacity: int,
    demand_units: Dict[str, int],
    hit_rates: Optional[Dict[str, float]] = None,
    *,
    topology: Optional[DeviceTopology] = None,
    device_weights: Optional[Dict[str, Dict[int, float]]] = None,
) -> PoolPlan:
    """Admission control + per-job unit allocation for a shared pool.

    Raises ``AdmissionError`` when the jobs cannot each be guaranteed one
    unit.  Otherwise allocates: 1 unit per job, then the surplus by largest
    remainder proportional to residual demand (capped at each job's demand —
    leftover capacity beyond aggregate demand stays idle for future jobs).

    ``hit_rates`` (job -> observed feature-cache hit rate) discounts each
    job's demand via ``effective_demand_units`` before allocation: a job
    whose partitions mostly arrive from the shared cache needs fewer produce
    units, so the surplus it frees rebalances to cold jobs.

    ``topology`` (which units are bound to which ISP device) switches on
    per-device provisioning: each device's units are split across jobs by
    largest remainder over ``effective demand x device weight``, where
    ``device_weights[job][device]`` is the fraction of the job's partitions
    that device owns (jobs without weights — e.g. produce_fn test hooks with
    no store — spread uniformly).  The per-device split is what isolates a
    cold device's jobs from a hot device's backlog.
    """
    if len(demand_units) > capacity:
        raise AdmissionError(
            f"pool of {capacity} unit(s) cannot guarantee 1 unit to each of "
            f"{len(demand_units)} job(s)"
        )
    demands = {j: max(1, int(d)) for j, d in demand_units.items()}
    if hit_rates:
        demands = {
            j: effective_demand_units(d, hit_rates.get(j, 0.0))
            for j, d in demands.items()
        }
    effective = dict(demands)
    shares = {j: 1 for j in demands}
    residual = {j: d - 1 for j, d in demands.items()}
    surplus = capacity - len(shares)
    total_res = sum(residual.values())
    alloc = min(surplus, total_res)
    if alloc > 0:
        quotas = {j: alloc * residual[j] / total_res for j in residual}
        floors = {j: math.floor(q) for j, q in quotas.items()}
        for j, f in floors.items():
            shares[j] += f
        leftover = alloc - sum(floors.values())
        for j in sorted(residual, key=lambda j: quotas[j] - floors[j], reverse=True):
            if leftover <= 0:
                break
            if shares[j] < demands[j]:
                shares[j] += 1
                leftover -= 1
    device_shares = _device_split(topology, demands, device_weights)
    return PoolPlan(capacity, dict(demand_units), shares, effective, device_shares)


def _device_split(
    topology: Optional[DeviceTopology],
    demands: Dict[str, int],
    device_weights: Optional[Dict[str, Dict[int, float]]],
) -> Optional[Dict[int, Dict[str, int]]]:
    """Per-device unit split across jobs (see ``plan_pool``'s docstring)."""
    if topology is None:
        return None
    ndev = max(len(topology.units_per_device), 1)
    device_shares: Dict[int, Dict[str, int]] = {}
    for d, units in sorted(topology.units_per_device.items()):
        w = {}
        for j in demands:
            jw = (device_weights or {}).get(j)
            frac = jw.get(d, 0.0) if jw is not None else 1.0 / ndev
            w[j] = demands[j] * frac
        device_shares[d] = _largest_remainder(units, w)
    return device_shares


def plan_pool_slo(
    capacity: int,
    requests: "list[SloRequest]",
    hit_rates: Optional[Dict[str, float]] = None,
    *,
    topology: Optional[DeviceTopology] = None,
    device_weights: Optional[Dict[str, Dict[int, float]]] = None,
) -> "tuple[PoolPlan, Dict[str, SloDecision]]":
    """QoS-tiered admission + allocation: reject/degrade, never starve.

    The SLO-aware twin of ``plan_pool``.  Jobs are considered in priority
    order (release-candidate before exploratory; arrival order within a
    tier).  The first ``capacity`` jobs in that order get the 1-unit floor;
    the rest are REJECTED with a decision the caller can surface — a
    release-candidate arriving into a full pool therefore preempts the
    youngest exploratory job's floor rather than being turned away behind
    it.  Surplus units are then granted tier by tier: the release-candidate
    tier's residual demand is satisfied before the exploratory tier sees a
    single surplus unit (proportional largest-remainder within each tier,
    capped at demand).  Every admitted job granted less than its effective
    demand is marked ``degraded`` — the caller knows it runs slow, which is
    the opposite of silent starvation.

    Returns ``(plan, decisions)``: the plan covers admitted jobs only and is
    shaped exactly like ``plan_pool``'s (drop-in for ``PoolPlan`` consumers);
    decisions cover every request, including the rejected ones.
    """
    order = sorted(range(len(requests)), key=lambda i: (requests[i].rank, i))
    admitted = [requests[i] for i in order[: max(capacity, 0)]]
    rejected = [requests[i] for i in order[max(capacity, 0):]]
    decisions: Dict[str, SloDecision] = {}
    for r in rejected:
        decisions[r.name] = SloDecision(
            r.name, "rejected", 0, r.qos_class,
            reason=f"no 1-unit floor in a {capacity}-unit pool "
                   f"({len(requests)} requests)",
        )
    demands = {r.name: max(1, int(r.demand_units)) for r in admitted}
    eff = dict(demands)
    if hit_rates:
        eff = {
            j: effective_demand_units(d, hit_rates.get(j, 0.0))
            for j, d in demands.items()
        }
    shares = {j: 1 for j in demands}
    surplus = capacity - len(shares)
    for rank in sorted({r.rank for r in admitted}):
        if surplus <= 0:
            break
        tier = [r.name for r in admitted if r.rank == rank]
        residual = {j: eff[j] - shares[j] for j in tier if eff[j] > shares[j]}
        total_res = sum(residual.values())
        alloc = min(surplus, total_res)
        if alloc <= 0:
            continue
        quotas = {j: alloc * residual[j] / total_res for j in residual}
        floors = {j: math.floor(q) for j, q in quotas.items()}
        for j, f in floors.items():
            shares[j] += f
        leftover = alloc - sum(floors.values())
        for j in sorted(residual, key=lambda j: quotas[j] - floors[j], reverse=True):
            if leftover <= 0:
                break
            if shares[j] < eff[j]:
                shares[j] += 1
                leftover -= 1
        surplus -= alloc
    for r in admitted:
        granted = shares[r.name]
        if granted >= eff[r.name]:
            decisions[r.name] = SloDecision(
                r.name, "admitted", granted, r.qos_class
            )
        else:
            decisions[r.name] = SloDecision(
                r.name, "degraded", granted, r.qos_class,
                reason=f"granted {granted} of {eff[r.name]} effective unit(s)",
            )
    plan = PoolPlan(
        capacity, demands, shares, eff,
        _device_split(topology, eff, device_weights),
    )
    return plan, decisions


def _cuda_devices(out: Any) -> set:
    """The CUDA devices of every tensor in a (nested) step output."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in out))
    return set()


def _wait(out: Any) -> None:
    """Wait until the device work behind `out` is done.  CPU tensors are
    complete when the call returns; CUDA ones are waited for on each of
    their devices."""
    for device in _cuda_devices(out):
        torch.cuda.synchronize(device)


def measure_throughput(
    step_fn: Callable[[], object], samples_per_step: int, *, iters: int = 10, warmup: int = 2
) -> ThroughputMeasurement:
    """Stress-test a compiled step with dummy inputs (paper's step 2)."""
    for _ in range(warmup):
        out = step_fn()
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step_fn()
    _wait(out)
    dt = time.perf_counter() - t0
    return ThroughputMeasurement(samples_per_step * iters / dt, iters, dt)


# -- Paper constants for the CPU-centric baseline (Fig. 4 / Fig. 14) ----------
# Cores required to saturate an 8xA100 node, as published (Fig. 4); RM-level
# per-core preprocessing throughput follows from the paper's training
# throughputs.  These anchor the cost/energy comparisons so the baseline is
# the PAPER's baseline, not a strawman.
PAPER_CORES_REQUIRED_8GPU = {"rm1": 124, "rm2": 243, "rm3": 297, "rm4": 321, "rm5": 367}
PAPER_ISP_UNITS_REQUIRED_8GPU = {"rm1": 3, "rm2": 6, "rm3": 8, "rm4": 8, "rm5": 9}
# Avg end-to-end preprocessing speedup of a single SmartSSD vs a single CPU
# core is implied by the two rows above scaling to the same T:
#   per-unit speedup(RM) = cores / isp_units


def paper_speedup_per_unit(rm: str) -> float:
    return PAPER_CORES_REQUIRED_8GPU[rm] / PAPER_ISP_UNITS_REQUIRED_8GPU[rm]
