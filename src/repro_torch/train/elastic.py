"""Elastic scaling and failure handling around the checkpoint substrate.

The port of ``repro.train.elastic``.  The contract that makes a restart
cheap is the reference's: checkpoints hold full leaves in one global format
whatever mesh wrote them (``checkpoint.py``), data is regenerable by (seed,
partition id), so a new incarnation replays from ``state["step"]`` and
loses nothing, and the fresh state is a pure function of the mesh.
``ElasticTrainer.run`` drives that loop: build the mesh -> build a state
and restore the latest checkpoint into it -> train -> on a simulated or
real failure, the caller runs it again, on the same mesh or another.  The
failure drill is the port's ``ctrlplane.FailureInjector``, the one the
pool-side chaos drills use.

The fields are the reference's.  ``make_mesh()`` gives this incarnation's
place: a ``launch.mesh.World`` (shape, axes, device kind) for a meshed
incarnation, or a ``torch.device`` for one device.  ``make_state``,
``make_step`` and ``state_shardings`` take what a rank sees: its
``launch.mesh.Mesh`` (or the device); ``state_shardings(mesh)`` is the spec
tree of the state (``train.step.state_shardings``), which the checkpoint
uses to save and restore the rank's blocks, and may be None for a trainer
that only runs on one device.

A meshed incarnation is a ``run_spmd`` world: ``run`` spawns it, every
rank bootstraps (the checkpoint read into its fresh blocks) and trains,
and the world's ranks exit when it ends or fails, releasing their device
memory before the caller's next ``run`` spawns the next world, whose shape
may differ.  What crosses to the ranks is pickled: ``make_state``,
``make_step``, ``state_shardings`` and ``batches`` (a list, or an object
that iterates anew in each rank, of ``(step_idx, global batch)``) must be
module-level or picklable; ``make_step(mesh)`` takes the rank's rows.  A
failure in a rank raises ``run_spmd``'s RuntimeError, which carries the
ranks' tracebacks.

The ranks' state goes with their world, so ``run`` returns one shape
wherever it ran: the step of its final checkpoint (which ``ckpt.restore``
reads into any mesh or one device) and the last step's metrics as floats
(rank 0's on a mesh).  Where the reference returns the state, a
one-device ``run`` leaves it in ``trainer.state``; a meshed run leaves
None there.

On one card a state is tens of GiB.  When a one-device ``run`` fails it
drops its own references to the state and the step before the exception
leaves it, so the traceback the caller holds (its frame is in it) pins no
device memory, and the next ``bootstrap`` can allocate a state of the same
size.  ``run`` skips its final save when the loop has just saved that step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.ctrlplane import FailureInjector
from repro_torch.launch.mesh import Mesh, World
from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class ElasticTrainer:
    make_mesh: Callable[[], Any]  # () -> World of this incarnation, or a torch.device
    make_state: Callable[[Any], Any]  # mesh (or device) -> fresh TrainState (the rank's blocks)
    make_step: Callable[[Any], Any]  # mesh (or device) -> train_step(state, batch)
    state_shardings: Optional[Callable[[Any], Any]]  # mesh -> spec tree of the state
    ckpt: CheckpointManager
    checkpoint_every: int = 50
    # the final state of the last one-device run (None after a meshed run)
    state: Any = dataclasses.field(default=None, init=False, repr=False)

    def bootstrap(self, mesh=None):
        """Build (mesh, state, step_fn), restoring into the fresh state if
        a checkpoint exists.  `mesh` is the rank's ``Mesh`` inside a meshed
        incarnation; without it, ``make_mesh()`` must give a device."""
        self.ckpt.wait()  # a save this process started is committed first
        if mesh is None:
            mesh = self.make_mesh()
            if isinstance(mesh, World):
                raise ValueError("a meshed incarnation bootstraps in its ranks: call run")
        state = self.make_state(mesh)
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, target=state, **self._layout(mesh))
        return mesh, state, self.make_step(mesh)

    def _layout(self, mesh) -> dict:
        if not isinstance(mesh, Mesh):
            return {}
        if self.state_shardings is None:
            raise ValueError("a meshed incarnation needs state_shardings")
        return {"mesh": mesh, "specs": self.state_shardings(mesh)}

    def run(
        self,
        batches,  # iterable of (step_idx, batch)
        *,
        max_steps: Optional[int] = None,
        fail_at: Optional[int] = None,  # simulate a node failure (test hook)
    ) -> Tuple[int, Dict[str, float]]:
        """Train from the latest checkpoint to `max_steps` (or the end of
        `batches`); returns (the final checkpoint's step, the last metrics
        as floats)."""
        self.state = None
        where = self.make_mesh()
        if isinstance(where, World):
            self.ckpt.wait()
            ranks = dataclasses.replace(self, make_mesh=None)
            results = where.run(_incarnation, args=(ranks, batches, max_steps, fail_at))
            return results[0]
        self.state, done, metrics = self._train(where, batches, max_steps, fail_at)
        return done, metrics

    def _train(self, where, batches, max_steps, fail_at):
        """(final state, its step, the last metrics as floats) of one
        incarnation on `where` (a rank's mesh or the one device)."""
        mesh, state, step_fn = self.bootstrap(where)
        done = saved = int(state["step"])
        metrics = batch = None
        inject = FailureInjector(fail_at=fail_at)  # shared chaos drill
        try:
            for i, batch in batches:
                if i < done:
                    continue  # replay-skip: data is deterministic in step idx
                inject.check(i)  # raises SimulatedFailure (a RuntimeError)
                state, metrics = step_fn(state, batch)
                done = i + 1
                if done % self.checkpoint_every == 0:
                    self.ckpt.save(done, state, **self._layout(mesh))
                    saved = done
                if max_steps is not None and done >= max_steps:
                    break
        except BaseException:
            # the traceback holds this frame: let it hold no state
            state = step_fn = metrics = batch = None
            raise
        if saved != done or self.ckpt.latest_step() is None:
            self.ckpt.save(done, state, **self._layout(mesh))
        self.ckpt.wait()
        return state, done, {k: float(v) for k, v in (metrics or {}).items()}


def _incarnation(mesh, trainer: ElasticTrainer, batches, max_steps, fail_at):
    """One rank of a meshed incarnation: bootstrap on the rank's mesh and
    train; (final step, last metrics) go back to ``run``."""
    _state, done, metrics = trainer._train(mesh, batches, max_steps, fail_at)
    return done, metrics
