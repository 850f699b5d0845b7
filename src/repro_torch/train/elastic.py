"""Failure handling and restart around the checkpoint substrate, on one device.

The port of ``repro.train.elastic``.  The contract that makes a restart
cheap is the reference's: checkpoints hold full leaves (``checkpoint.py``),
data is regenerable by (seed, partition id), so a new incarnation replays
from ``state["step"]`` and loses nothing, and the fresh state is a pure
function of the device.  ``ElasticTrainer.run`` drives that loop: pick the
device -> build a state and restore the latest checkpoint into it -> train
-> on a simulated or real failure, the caller runs it again.  The failure
drill is the port's ``ctrlplane.FailureInjector``, the one the pool-side
chaos drills use.

Fields renamed from the reference, and why: the port runs on one device
with no mesh, so ``make_mesh`` is ``make_device`` (() -> the device this
incarnation runs on), and ``make_state``/``make_step`` take that device.
The reference's ``state_shardings`` has no counterpart: ``restore`` copies
each leaf into the fresh state's own tensors, which already lie on the
device.

On the card a state is tens of GiB.  When ``run`` fails it drops its own
references to the state and the step before the exception leaves it, so
the traceback the caller holds (its frame is in it) pins no device memory,
and the next ``bootstrap`` can allocate a state of the same size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.ctrlplane import FailureInjector
from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class ElasticTrainer:
    make_device: Callable[[], torch.device]  # () -> the device of this incarnation
    make_state: Callable[[torch.device], Any]  # device -> fresh TrainState
    make_step: Callable[[torch.device], Any]  # device -> train_step(state, batch)
    ckpt: CheckpointManager
    checkpoint_every: int = 50

    def bootstrap(self):
        """Build (device, state, step_fn), restoring into the fresh state if
        a checkpoint exists."""
        self.ckpt.wait()  # a save this process started is committed first
        device = self.make_device()
        state = self.make_state(device)
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, target=state)
        return device, state, self.make_step(device)

    def run(
        self,
        batches,  # iterable of (step_idx, batch)
        *,
        max_steps: Optional[int] = None,
        fail_at: Optional[int] = None,  # simulate a node failure (test hook)
    ):
        _device, state, step_fn = self.bootstrap()
        done = int(state["step"])
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
                    self.ckpt.save(done, state)
                if max_steps is not None and done >= max_steps:
                    break
        except BaseException:
            # the traceback holds this frame: let it hold no state
            state = step_fn = metrics = batch = None
            raise
        self.ckpt.save(done, state)
        self.ckpt.wait()
        return state, metrics
