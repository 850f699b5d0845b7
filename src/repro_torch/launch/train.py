"""Training driver: end-to-end RecSys training fed by PreSto, or LM
training, on one device.

The port of ``repro.launch.train``.  RecSys mode is the paper's full Fig. 1
pipeline: the ``PartitionedStore`` serves encoded columnar partitions, the
``TorchPreStoEngine`` transforms them (the fused kernels under ``presto``
placement) inside a ``PreprocessingService`` session, the DLRM trains on
the delivered mini-batches through ``TrainingPipeline.run_session``, and
``--ckpt-dir`` saves the final state in the reference's checkpoint format.
LM mode trains any ``--arch`` (default mamba2-1.3b) on ``TokenSynthesizer``
shards, with ``cfg.optimizer`` over the reference's schedule
(``launch.specs.make_optimizer_for``); an encoder-decoder arch gets random
frames and a VLM random prefix embeddings, drawn from a generator seeded
by ``--seed`` on the device.

The flags are the reference's plus ``--device`` (CUDA by default, raising
when no card is present; ``cpu`` runs the kernels' plain PyTorch
versions).  ``train_recsys`` returns the reference's dict (``first_loss``,
``last_loss``, ``steps``) with every step's loss (``losses``), every step's
time in ms (``step_ms``: CUDA events around the step on the card, the host
clock on the CPU) and the checkpoint's ``last_save`` record
(``checkpoint``: path, bytes, and the seconds of the host snapshot and of
the writes; None without ``--ckpt-dir``).  ``train_lm`` prints the
reference's summary line and one with the median step ms, tokens/s and the
card's name and power limit, and returns ``first_loss``, ``last_loss``,
``losses`` and ``step_ms``.

  PYTHONPATH=src python -m repro_torch.launch.train --mode recsys --rm rm1 \
      --reduced --steps 50 --rows 512 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
      --arch mamba2-1.3b --reduced --steps 20 --batch 8 --seq 256 --device cpu
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.common.util import card_line, resolve_device
from repro_torch.configs.registry import get_arch, get_recsys
from repro_torch.core.pipeline import TrainingPipeline
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.service import JobSpec, PreprocessingService
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.data.tokens import TokenSynthesizer
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.specs import _model_module, make_optimizer_for
from repro_torch.models import recsys as RS
from repro_torch.models.layers import ParamTree
from repro_torch.models.transformer import dtype_of
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


def lm_batch(synth: TokenSynthesizer, cfg, step: int, batch: int, seq: int,
             device: torch.device, generator: torch.Generator) -> dict:
    """The driver's batch of step `step`: the synthesizer's tokens, labels
    and mask (as f32) on `device`, with frames (enc-dec) or prefix
    embeddings (VLM) drawn from `generator`, in ``cfg.dtype``."""
    raw = synth.shard_batch(0, step, batch)
    out = {"tokens": torch.from_numpy(raw["tokens"]).to(device),
           "labels": torch.from_numpy(raw["labels"]).to(device),
           "mask": torch.from_numpy(raw["mask"]).to(device, torch.float32)}
    dt = dtype_of(cfg.dtype)
    if cfg.is_encdec:
        out["frames"] = torch.randn((batch, seq, cfg.d_model), generator=generator,
                                    device=device).to(dt)
    if cfg.family == "vlm" and cfg.frontend_positions:
        out["prefix_embeds"] = torch.randn((batch, cfg.frontend_positions, cfg.d_model),
                                           generator=generator, device=device).to(dt)
    return out


def train_lm(args) -> dict:
    device = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.reduced if args.reduced else entry.config
    mod = _model_module(cfg)
    rules = ShardingRules.make(None)
    opt = make_optimizer_for(cfg)
    step, step_ms = timed_step(
        make_train_step(lambda m, b: mod.loss_fn(m.tree(), b, cfg, rules), opt), device)

    model = ParamTree(mod.init_params(torch.Generator().manual_seed(args.seed), cfg, device))
    state = init_state(model, opt)
    synth = TokenSynthesizer(cfg.vocab_size, args.seq, seed=args.seed)
    gen = torch.Generator(device).manual_seed(args.seed)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = lm_batch(synth, cfg, i, args.batch, args.seq, device, gen)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    wall = time.time() - t0
    ms = step_ms()
    med = statistics.median(ms)
    print(f"lm {cfg.name}: {args.steps} steps in {wall:.1f}s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"lm {cfg.name} on {device}: step {med:.3f} ms (median; first {ms[0]:.3f}), "
          f"{args.batch * args.seq / (med / 1e3):.1f} tok/s; card {card_line(device)}")
    return {"first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
            "step_ms": ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["recsys", "lm"], default="recsys")
    ap.add_argument("--rm", default="rm1")
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--placement", choices=["presto", "disagg", "hybrid"],
                    default="presto")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--partitions", type=int, default=64)
    ap.add_argument("--rows", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--store-root", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    return train_recsys(args) if args.mode == "recsys" else train_lm(args)


if __name__ == "__main__":
    main()
