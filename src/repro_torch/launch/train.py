"""Training driver: end-to-end RecSys training fed by PreSto, on one device.

The port of ``repro.launch.train``'s RecSys mode, the paper's full Fig. 1
pipeline: the ``PartitionedStore`` serves encoded columnar partitions, the
``TorchPreStoEngine`` transforms them (the fused kernels under ``presto``
placement) inside a ``PreprocessingService`` session, the DLRM trains on
the delivered mini-batches through ``TrainingPipeline.run_session``, and
``--ckpt-dir`` saves the final state in the reference's checkpoint format.

The flags are the reference's RecSys flags plus ``--device`` (CUDA by
default, raising when no card is present; ``cpu`` runs the kernels' plain
PyTorch versions).  ``--mode lm`` and its flags (``--arch``, ``--batch``,
``--seq``) wait for the port of the LM side.  ``train_recsys`` returns the
reference's dict (``first_loss``, ``last_loss``, ``steps``) with every
step's loss (``losses``), every step's time in ms (``step_ms``: CUDA
events around the step on the card, the host clock on the CPU) and the
checkpoint's ``last_save`` record (``checkpoint``: path, bytes, and the
seconds of the host snapshot and of the writes; None without
``--ckpt-dir``).

  PYTHONPATH=src python -m repro_torch.launch.train --mode recsys --rm rm1 \
      --reduced --steps 50 --rows 512 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.common.util import resolve_device
from repro_torch.configs.registry import get_recsys
from repro_torch.core.pipeline import TrainingPipeline
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.service import JobSpec, PreprocessingService
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.models import recsys as RS
from repro_torch.train import (
    CheckpointManager,
    adamw,
    init_state,
    make_train_step,
    warmup_cosine,
)


def timed_step(step, device: torch.device):
    """``step`` wrapped to time each call, and a function that reads the
    times in ms once the steps are done: CUDA events on the card (no sync
    between steps), the host clock on the CPU, where a step is synchronous."""
    marks = []

    def run(state, batch):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(state, batch)
            b.record()
            marks.append((a, b))
        else:
            t0 = time.perf_counter()
            out = step(state, batch)
            marks.append((time.perf_counter() - t0) * 1e3)
        return out

    def read_ms():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            return [a.elapsed_time(b) for a, b in marks]
        return list(marks)

    return run, read_ms


def recsys_step(rcfg, lr: float, steps: int):
    """The driver's optimizer and train step: AdamW over a warmup-cosine
    schedule (20 warmup steps, at least 100 in all) and the DLRM's loss."""
    opt = adamw(warmup_cosine(lr, 20, max(steps, 100)))
    return opt, make_train_step(lambda m, b: RS.loss_fn(m, b, rcfg), opt)


def train_recsys(args) -> dict:
    device = resolve_device(args.device)
    rcfg = get_recsys(args.rm, reduced=args.reduced)
    src = SyntheticRecSysSource(rcfg.data, rows=args.rows or None)
    spec = TransformSpec.from_source(src)
    store = PartitionedStore(args.partitions, num_devices=8, source=src,
                             root=args.store_root)
    engine = TorchPreStoEngine(spec, placement=args.placement, device=device)

    opt, step = recsys_step(rcfg, args.lr, args.steps)
    step, step_ms = timed_step(step, device)

    model = RS.init_params(torch.Generator().manual_seed(args.seed), rcfg, device)
    state = init_state(model, opt)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    pipeline = TrainingPipeline(train_step=step)
    t0 = time.time()
    with PreprocessingService(num_workers=args.workers) as service:
        session = service.submit(JobSpec(
            name=f"{rcfg.name}-{args.placement}", engine=engine, store=store,
            partitions=range(args.partitions), units=args.workers))
        state, stats, metrics = pipeline.run_session(
            state, session, max_steps=args.steps
        )
    wall = time.time() - t0
    saved = None
    if ckpt:
        path = ckpt.save(int(state["step"]), state)
        ckpt.wait()
        saved = dict(ckpt.last_save, path=path)
    losses = [m["loss"] for m in metrics]
    first, last = losses[0], losses[-1]
    print(f"recsys {rcfg.name} [{args.placement}] on {device}: {stats.steps} steps in "
          f"{wall:.1f}s, loss {first:.4f} -> {last:.4f}, "
          f"consumer-util {stats.utilization:.2f}, reissues {stats.reissues}")
    if saved:
        gb = saved["bytes"] / 1e9
        print(f"checkpoint step {saved['step']}: {saved['bytes']} bytes to {saved['path']}, "
              f"host snapshot {saved['snapshot_s']:.3f} s, write {saved['write_s']:.3f} s "
              f"({gb / max(saved['write_s'], 1e-9):.3f} GB/s)")
    return {"first_loss": first, "last_loss": last, "steps": stats.steps,
            "losses": losses, "step_ms": step_ms(), "checkpoint": saved}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["recsys"], default="recsys",
                    help="recsys (lm waits for the port of the LM side)")
    ap.add_argument("--rm", default="rm1")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--placement", choices=["presto", "disagg", "hybrid"],
                    default="presto")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--partitions", type=int, default=64)
    ap.add_argument("--rows", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--store-root", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    return train_recsys(args)


if __name__ == "__main__":
    main()
