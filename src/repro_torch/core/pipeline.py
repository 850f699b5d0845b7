"""Training-side client of a preprocessing Session (paper Fig. 9 consumer).

The port's own copy of ``repro.core.pipeline``.  A train step's metrics are
tensors on the step's device; ``run_session`` reads each one with
``float()`` inside the timed step, which waits for the step's work (one
sync per step, as the reference's ``block_until_ready``).
``provision_by_placement`` dispatches its probe through the engine's
``launch``/``deliver`` pair and times the lowered stages with
``opgraph.time_stages``, which synchronises the device around each stage.

TrainingPipeline is the train manager: it drains one ``core.service.Session``
(the input queue) into the accelerator step and accounts utilization the way
the paper's Fig. 3 does — consumer utilization = time inside train steps /
wall time; starvation = time blocked on the queue.

New API (multi-tenant, shared pool):

    service = PreprocessingService(num_workers=4)
    session = service.submit(JobSpec(name="job", spec=spec, store=store,
                                     partitions=range(64)))
    pipe = TrainingPipeline(train_step=step)
    state, stats, metrics = pipe.run_session(state, session)

Deprecated single-job shim (identical behavior, warns): the original
``TrainingPipeline(engine, store, train_step)`` constructor plus ``run()``,
which now spins up a private one-job ``PreprocessingService`` per call.

Provisioning (paper §IV-B steps 2-3) stays here: ``provision`` measures T
with a probe batch and P per worker; ``provision_by_placement`` times the
lowered graph stages per placement group (core.planner does the ceil(T/P)).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Iterable, Optional

from repro_torch.common.util import span
from repro_torch.core.opgraph import group_times_by_placement, time_stages
from repro_torch.core.planner import (
    PlacementProvisioning,
    ProvisioningPlan,
    measure_throughput,
)
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.service import JobSpec, PreprocessingService, Session
from repro_torch.data.storage import PartitionedStore


@dataclasses.dataclass
class PipelineStats:
    steps: int = 0
    train_time_s: float = 0.0
    starved_time_s: float = 0.0
    wall_time_s: float = 0.0
    reissues: int = 0

    @property
    def utilization(self) -> float:
        return self.train_time_s / max(self.wall_time_s, 1e-9)


class TrainingPipeline:
    def __init__(
        self,
        engine: Optional[TorchPreStoEngine] = None,
        store: Optional[PartitionedStore] = None,
        train_step: Optional[Callable] = None,  # (state, minibatch) -> (state, metrics)
        *,
        num_workers: int = 2,
        queue_depth: int = 4,
        straggler_timeout: float = 30.0,
    ):
        self.engine = engine
        self.store = store
        self.train_step = train_step
        self.num_workers = num_workers
        self.queue_depth = queue_depth
        self.straggler_timeout = straggler_timeout

    def _produce(self, pid: int):
        """One preprocessing worker's job: Extract + Transform one partition."""
        assert self.engine is not None and self.store is not None
        return self.engine.produce_batch(self.store, pid)

    def _measure_train_throughput(self, state, probe):
        """Paper step 2's T: stress the train step with one probe batch."""
        rows = int(probe["labels"].shape[0])
        state_holder = [state]

        def train_once():
            new_state, metrics = self.train_step(state_holder[0], probe)
            state_holder[0] = new_state
            return metrics

        return measure_throughput(train_once, rows, iters=5, warmup=2), rows

    def provision(self, state, partition_for_probe: int = 0) -> ProvisioningPlan:
        """Paper step 2: measure T with dummy batches, P per worker, plan T/P."""
        probe = self._produce(partition_for_probe)
        t_meas, rows = self._measure_train_throughput(state, probe)
        p_meas = measure_throughput(
            lambda: self._produce(partition_for_probe), rows, iters=3, warmup=1
        )
        return ProvisioningPlan.derive(t_meas.samples_per_s, p_meas.samples_per_s)

    def provision_by_placement(
        self, state, partition_for_probe: int = 0
    ) -> PlacementProvisioning:
        """Per-placement-group T/P: time the engine's lowered graph stages,
        aggregate per group (isp / host / local assembly), provision each
        group's units independently — ISP units and host workers are
        different resources in hybrid placement."""
        engine = self.engine
        pinned = engine.pin_pages(engine.stage_megabatch(self.store, [partition_for_probe]))
        (probe,), done = engine.launch(pinned)
        engine.deliver(done)
        t_meas, rows = self._measure_train_throughput(state, probe)
        plan = engine.lowered_plan
        times = time_stages(plan, engine.put_pages({k: v[0] for k, v in pinned.items()}))
        groups = group_times_by_placement(plan, times)
        group_P = {g: rows / max(t, 1e-9) for g, t in groups.items()}
        return PlacementProvisioning.derive(t_meas.samples_per_s, group_P)

    # -- the train-manager loop ------------------------------------------------

    def run_session(
        self,
        state,
        session: Session,
        *,
        max_steps: Optional[int] = None,
    ) -> tuple[object, PipelineStats, list]:
        """Drain a Session into the train step (the Fig. 9 consumer loop).

        Stops after ``max_steps`` (cancelling the rest of the job so its pool
        units go back to other tenants) or when the session is exhausted.
        Each step, with the read of its metrics, runs in the span
        ``pipeline.step`` (``common.util.span``).
        """
        assert self.train_step is not None, "run_session needs a train_step"
        stats = PipelineStats()
        metrics_log: list = []
        wall0 = time.perf_counter()
        try:
            q0 = time.perf_counter()
            for pid, mb in session:
                stats.starved_time_s += time.perf_counter() - q0
                t0 = time.perf_counter()
                with span("pipeline.step"):
                    state, metrics = self.train_step(state, mb)
                    # reading the metrics waits for the step's device work
                    metrics = {k: float(v) for k, v in metrics.items()}
                stats.train_time_s += time.perf_counter() - t0
                stats.steps += 1
                metrics_log.append(metrics)
                if max_steps is not None and stats.steps >= max_steps:
                    break
                q0 = time.perf_counter()
        finally:
            if not session.done:
                session.cancel()
        stats.wall_time_s = time.perf_counter() - wall0
        stats.reissues = session.stats().reissues
        return state, stats, metrics_log

    # -- deprecated single-job shim --------------------------------------------

    def run(
        self,
        state,
        partition_ids: Iterable[int],
        *,
        max_steps: Optional[int] = None,
    ) -> tuple[object, PipelineStats, list]:
        """Deprecated: private-pool single-job execution (identical behavior).

        Spins up an ephemeral one-job PreprocessingService; prefer submitting
        a JobSpec to a shared service and calling ``run_session``.
        """
        if self.engine is None or self.store is None:
            raise ValueError(
                "run() requires the deprecated TrainingPipeline(engine, store, "
                "train_step) construction; submit a JobSpec to a "
                "PreprocessingService and use run_session() instead"
            )
        warnings.warn(
            "TrainingPipeline.run(partition_ids) with a private worker pool is "
            "deprecated; submit a JobSpec to a PreprocessingService and use "
            "run_session()",
            DeprecationWarning,
            stacklevel=2,
        )
        with PreprocessingService(num_workers=self.num_workers) as service:
            session = service.submit(
                JobSpec(
                    name="training-pipeline",
                    partitions=list(partition_ids),
                    engine=self.engine,
                    store=self.store,
                    units=self.num_workers,
                    queue_depth=self.queue_depth,
                    straggler_timeout=self.straggler_timeout,
                )
            )
            return self.run_session(state, session, max_steps=max_steps)
