"""Quickstart: the PreSto pipeline in ~40 lines, as a service client.

The port of ``examples/quickstart.py``.  Submits one job to a
``PreprocessingService`` (the shared ISP pool): the service's workers
Extract encoded columnar partitions and Transform them with the fused
kernels (decode + Bucketize + SigridHash + Log on the card); the returned
``Session`` streams train-ready mini-batches that a DLRM consumes.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.common.util import resolve_device
from repro_torch.configs.registry import get_recsys
from repro_torch.core.service import JobSpec, PreprocessingService
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.models import recsys as RS
from repro_torch.train import adamw, init_state, make_train_step, warmup_cosine


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default CUDA)")
    device = resolve_device(ap.parse_args(argv).device)

    # 1. storage: a synthetic RM1-style dataset, five 512-row partitions
    rcfg = get_recsys("rm1", reduced=True)
    src = SyntheticRecSysSource(rcfg.data, rows=512)
    spec = TransformSpec.from_source(src)
    store = PartitionedStore(5, num_devices=4, source=src)
    print(f"partition: {src.partition(0).nbytes()/1e6:.2f} MB encoded columnar pages")

    # 2. Transform-as-a-service: submit the job, stream mini-batches
    service = PreprocessingService(num_workers=2)
    session = service.submit(JobSpec(
        name="quickstart", spec=spec, store=store,
        partitions=range(5), placement="presto", device=device))

    # 3. Load + train: DLRM consumes the session's stream
    model = RS.init_params(torch.Generator().manual_seed(0), rcfg, device)
    opt = adamw(warmup_cosine(1e-3, 5, 100))
    step = make_train_step(lambda m, b: RS.loss_fn(m, b, rcfg), opt)
    state = init_state(model, opt)
    losses = []
    for i, (pid, mb) in enumerate(session):
        state, metrics = step(state, mb)
        losses.append(float(metrics["loss"]))
        print(f"step {i} (partition {pid}): loss={losses[-1]:.4f} "
              f"acc={float(metrics['accuracy']):.3f}")
    st = session.stats()
    print(f"session: {st.delivered}/{st.total} batches, "
          f"{st.achieved_samples_per_s:.0f} samples/s, "
          f"starvation {st.starvation:.2f}")
    service.close()
    return losses


if __name__ == "__main__":
    main()
