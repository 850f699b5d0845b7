"""End-to-end driver: train a ~100M-parameter DLRM through the full PreSto
pipeline (Fig. 1): Extract (columnar store) -> Transform (fused kernels,
shared service pool) -> Load (session stream) -> train (consumer), with T/P
provisioning driving the job's QoS target, checkpointing, and restart
safety.

The port of ``examples/train_recsys_e2e.py``.  The parameter count is the
model's ``p.numel()`` summed.  The port's train step updates the state in
place, so provisioning (which times train steps on a probe batch) would
train the model on the probe: the state is checkpointed before it and
restored in place after it, and training starts from step 0 as in the
reference.

    PYTHONPATH=src python -m repro_torch.examples.train_recsys_e2e [--steps 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.common.util import resolve_device
from repro_torch.core.pipeline import TrainingPipeline
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.service import JobSpec, PreprocessingService
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import RMDataConfig, SyntheticRecSysSource
from repro_torch.models.recsys import RecSysConfig, init_params, loss_fn
from repro_torch.train import (
    CheckpointManager,
    adamw,
    init_state,
    make_train_step,
    warmup_cosine,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default=None, help="torch device (default CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ~100M params: RM1 feature geometry with 20k-row embedding tables
    # (39 tables x 20,000 x 128 = 99.8M) + MLPs.
    data = RMDataConfig("rm1-100m", 13, 26, 1, 1, 13, 1024, 1 << 20, 20_000,
                        rows_per_partition=args.rows)
    rcfg = RecSysConfig(name="rm1-100m", data=data)
    src = SyntheticRecSysSource(data, rows=args.rows)
    spec = TransformSpec.from_source(src)
    store = PartitionedStore(args.steps + 8, num_devices=8, source=src)
    engine = TorchPreStoEngine(spec, device=device)

    model = init_params(torch.Generator().manual_seed(0), rcfg, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params/1e6:.1f}M parameters")
    opt = adamw(warmup_cosine(2e-3, 20, args.steps))
    step = make_train_step(lambda m, b: loss_fn(m, b, rcfg), opt)
    state = init_state(model, opt)

    with tempfile.TemporaryDirectory() as ckdir:
        ckpt = CheckpointManager(ckdir, keep=2)
        ckpt.save(0, state)
        pipe = TrainingPipeline(engine, store, step)
        plan = pipe.provision(state)
        ckpt.wait()
        ckpt.restore(0, target=state)  # undo the probe's in-place steps
        print(f"provisioning: T={plan.train_throughput:.0f} rows/s, "
              f"P={plan.worker_throughput:.0f} rows/s/worker -> "
              f"{plan.workers_required} preprocessing workers (paper step 2: T/P)")

        # the provisioned pool, as a service; the job's QoS target is the
        # measured training throughput T, so demand converges to ceil(T/P)
        service = PreprocessingService(num_workers=args.workers)
        session = service.submit(JobSpec(
            name="rm1-100m", engine=engine, store=store,
            partitions=range(args.steps + 8),
            target_samples_per_s=plan.train_throughput))

        t0 = time.time()
        state, stats, metrics = pipe.run_session(
            state, session, max_steps=args.steps
        )
        ckpt.save(int(state["step"]), state)
        ckpt.wait()
        wall = time.time() - t0
        losses = [m["loss"] for m in metrics]
        k = max(len(losses) // 10, 1)
        sess_stats = session.stats()
        print(f"trained {stats.steps} steps ({stats.steps*args.rows} samples) "
              f"in {wall:.0f}s; consumer-util {stats.utilization:.2f}; "
              f"straggler re-issues {stats.reissues}; "
              f"QoS demand {sess_stats.demand_units} unit(s)")
        print(f"loss: first10={np.mean(losses[:k]):.4f} "
              f"last10={np.mean(losses[-k:]):.4f} (should decrease)")
        latest = ckpt.latest_step()
        print(f"checkpoint at step {latest} -> restart-safe")
        assert np.mean(losses[-k:]) < np.mean(losses[:k]), "loss did not improve"
    service.close()
    return {"params": n_params, "losses": losses, "steps": stats.steps,
            "checkpoint_step": latest, "plan": plan}


if __name__ == "__main__":
    main()
