#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each of the eight kernels against its plain PyTorch version on the
card (adversarial words at the test shapes and at the rm2 and rm5 shapes,
unaligned views, plus the pinned NaN, +inf and subnormal edge cases; the
bit-packed kernels at every width 1..32, ragged G, the megabatch-2 shape and
views 4 bytes past 16-byte alignment; the bucket kernels at rm2 (megabatch 1
and 2), rm4 and rm5, a ragged R, unpadded boundary counts, offset views and
boundary counts searched in device memory), then drives these paths at full
RM2 width, each with the launch counters set to 0 just before it and read
just after:

* ``presto`` (the fused kernels): ``produce_stream`` over pids 0-3 of one
  8-partition ``PartitionedStore`` at megabatch 1 and 4-7 at megabatch 2,
  every batch held against the port's plain path (the same engine on the
  CPU);
* ``disagg`` with ``kernel_mode="unfused"`` (the five standalone kernels):
  pids 0-3 at megabatch 1;
* ``hybrid`` (the cost model's placement): pids 4-7 at megabatch 2;
* dedup (RecD): a store whose every 4 rows share one sparse block, 4
  partitions under presto (megabatch 1 and 2), unfused (1) and hybrid (2),
  every batch held against the inflated partition's fused batch and the
  plain path;
* the store (``phase_store``): 4 classic and 4 dedup partitions written as
  files to a temporary directory; host staging timed as generation, file
  read, and page build and pin; ``PrefetchLoader`` (2 workers) over the
  files (one counted pass, then 3 timed runs of 40 produces) and over the
  source, every batch bitwise the main path's; the
  feature cache at 2 batches (eviction spills, spill hits promote, every
  hit bitwise); every dedup partition assembled from its cached blocks by
  the rest program (``fused_dense`` and ``fused_gen``, no sparse kernel),
  bitwise its cold produce; a seeded transient spec, a torn read and a
  dedup ref outside [0, u) (raised on the host; the context survives);
* the preprocessing service (``phase_service``): the server entry point
  ``repro_torch.launch.serve_preprocess.main`` in-process, two tenants of
  the same content per drill, every delivered batch held bitwise against a
  solo recompute on the card (``--verify``, whose launches are counted
  apart from the drill's path): the service drill (cache, megabatch 2,
  lookahead 2; cache hits and pre-staged bytes required), the dedup drill
  (dup 4 from a pool of 16 blocks; block assemblies required, each
  launching exactly ``fused_dense`` and ``fused_gen``) and the storage
  fault drill (transient, torn, spill and a device offline; no partition
  quarantined, the context survives); then a worker killed mid-read
  through the service API, its claims re-issued;
* training: three reduced-width DLRM steps on the card against the CPU
  from the same weights, then the full RM2 DLRM (63 tables of 500,000 x 128
  floats, ~61 GiB with AdamW, freed after) for 8 train steps on the presto
  path's 8 batches and 3 ingest steps (pages in, the fused kernels inside
  the step) on one partition, whose loss must fall, and 4 more steps from
  the same state through ``TrainingPipeline.run_session``, fed by a
  service session (2 workers) over the store's 4 classic partition files;
* the training driver (``phase_driver``): ``repro_torch.launch.train.main``
  at full rm2 width (4 steps fed by a 2-worker service session over 6
  source partitions), then at full rm1 width with ``--ckpt-dir`` under
  ``build/`` (a 29.99 GB checkpoint: rm2's, 45.11 GiB, is more than the
  45 GiB one run may write to the GPU machine's disk); the free disk and
  host memory are checked first, and the host snapshot and the writes
  timed;
* the restore (``phase_restore``): that checkpoint restored in place into
  a zeroed state of the same structure, every leaf held bitwise against
  its ``.npy``, the peak of device memory within 1 GiB of the state;
* the elastic drill (``phase_elastic``): ``ElasticTrainer`` over the
  driver's step at rm2's feature geometry with 25,000-row tables,
  checkpoints every 2 steps, a failure at step 3 whose state is released
  while the exception is held, a second incarnation that restores step 2
  and ends at step 4 within 1e-5 of a run that never failed;
* the examples (``phase_examples``): ``repro_torch.examples.quickstart``,
  ``train_recsys_e2e --steps 40`` (its loss must fall) and the kernel
  level of ``presto_vs_disagg`` (rm5, 1,024 rows, fused against unfused);
* the simulator (``phase_sim``): one seeded ``SimHarness`` schedule of
  1,000 sessions with kills and a join, replayed twice, the traces equal;

and holds every unfused and hybrid batch bitwise against the fused batch of
the same pid, dense included.  The lengths decode runs the ``bitunpack``
kernel through its own entry point and is counted and timed apart as
``bitunpack.lengths``.  It prints the unfused plan's per-stage latency
breakdown (the paper's Fig. 5/12), per-kernel times beside their bounds
(CUDA-event times, each kernel's device time from the profiler, and the
device time of one copy of its input as the floor a launch of that size
meets; the latency-bound rows also at the megabatch-2 and rm5 shapes, the
bucket kernels also at m = 32769 and 65536), the presto path's time split,
each path's device busy time per partition, the trainer's step time,
device split, samples/s and peak memory, one JSON line describing the
kernels, the card's name and power limit, and, as its last line,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import gc
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
DENSE_TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=True)  # log1p: 1 ulp
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "fused_dense": CSRC + "fused.cu",
    "fused_sparse": CSRC + "fused.cu",
    "fused_gen": CSRC + "fused.cu",
    "bitunpack": CSRC + "decode.cu",
    "bitunpack.lengths": CSRC + "decode.cu",
    "bytesplit": CSRC + "decode.cu",
    "sigridhash": CSRC + "sigridhash.cu",
    "bucketize": CSRC + "bucketize.cu",
    "lognorm": CSRC + "lognorm.cu",
}
REPLACES = {
    "fused_dense": "src/repro/kernels/fused.py:32",
    "fused_sparse": "src/repro/kernels/fused.py:106",
    "fused_gen": "src/repro/kernels/fused.py:81",
    "bitunpack": "src/repro/kernels/decode.py:49",
    "bitunpack.lengths": "src/repro/kernels/decode.py:49",
    "bytesplit": "src/repro/kernels/decode.py:84",
    "sigridhash": "src/repro/kernels/sigridhash.py:43",
    "bucketize": "src/repro/kernels/bucketize.py:52",
    "lognorm": "src/repro/kernels/lognorm.py:25",
}
# the launch counter each lowered stage kind adds to; the lengths decode runs
# B4 at the lengths' width and is counted apart ("bitunpack.lengths")
STAGE_KERNELS = {
    "fused:decode.bytesplit+lognorm": "fused_dense",
    "fused:decode.bitpack+sigridhash": "fused_sparse",
    "fused:decode.bytesplit+bucketize+sigridhash": "fused_gen",
    "decode.bitpack": "bitunpack",
    "decode.lengths": "bitunpack.lengths",
    "decode.bytesplit": "bytesplit",
    "sigridhash": "sigridhash",
    "bucketize": "bucketize",
    "lognorm": "lognorm",
}
TRANSFORM_KINDS = ("bucketize", "sigridhash", "lognorm")
ALL_WIDTHS = tuple(range(1, 33))
# kernel-vs-plain cases: the test shapes (G not a multiple of 128), then the
# rm2 page shapes (megabatch 1 and 2) and, for fused_gen, rm5's 4096
# boundaries
DENSE_CASES = ((3, 1), (3, 130), (504, 2048))  # (F, G)
SPARSE_CASES = ((3, 1, ALL_WIDTHS), (3, 130, ALL_WIDTHS), (42, 8192, (24,)),
                (42, 16384, (24,)))  # (F, G, widths)
GEN_CASES = ((3, 1, 32), (3, 130, 32), (3, 1, 600), (3, 130, 600),
             (21, 2048, 1024), (21, 4096, 1024), (42, 2048, 2048),
             (42, 2048, 4096))  # (F, G, m): rm2 at K=1 and 2, rm4, rm5
# the standalone kernels: test shapes, then the rm2 shapes of the unfused
# plan (decode_sparse, decode_lengths, each at megabatch 1 and 2;
# decode_dense, decode_gen; hash_sparse, hash_gen; bucketize_gen, and rm5's
# 4096 boundaries; lognorm_dense)
BITUNPACK_CASES = ((3, 1, ALL_WIDTHS), (3, 130, ALL_WIDTHS), (42, 8192, (24,)),
                   (42, 16384, (24,)), (42, 256, (6,)), (42, 512, (6,)))
# the bit-packed kernels also take every width as a view 4 bytes past
# 16-byte alignment, where no tile may go by bulk copy
BITPACK_OFFSET_CASES = ((3, 130, ALL_WIDTHS), (42, 256, (6,)))
BYTESPLIT_CASES = ((3, 1), (3, 130), (504, 2048), (21, 2048))  # (F, G)
HASH_CASES = ((3, 1), (3, 1500), (3, 1027), (42, 262144), (21, 8192))  # (F, N)
BUCKETIZE_CASES = ((3, 5, 32), (3, 1500, 32), (3, 5, 600), (3, 1500, 600),
                   (21, 8192, 1024), (21, 16384, 1024), (21, 8191, 1024),
                   (42, 8192, 2048), (42, 8192, 4096))  # (F, R, m)
# the bucket kernels also take boundaries as given (m not padded to 128, so
# the tree has NaN slots and no row is a multiple of 4 floats), and views 4
# bytes past 16-byte alignment: the values of bucketize at full width, the
# boundaries of both, where every access goes by 4 bytes
UNPADDED_M = (1, 3, 127, 129)
BUCKET_OFFSET_CASES = ((21, 8192, 1024), (3, 1500, 600))  # (F, R, m)
# boundary counts whose tree does not fit in shared memory, searched in
# device memory (ROADMAP C8), given unpadded: the first such m, a padded one,
# and one at a ragged R
DEVICE_SEARCH_CASES = ((3, 1500, 32769), (3, 1500, 65536), (4, 1028, 40001))  # (F, R, m)
LOGNORM_CASES = ((3, 5, 7), (1027,), (504, 8192))
MAIN_CONFIG, MAIN_ROWS = "rm2", None  # full width, 8192 rows per partition
DEDUP_FACTOR = 4  # rows per shared sparse block of the dedup store
LOADER_RUNS, LOADER_CYCLES = 3, 10  # loader rate: 3 runs of the 4 file pids cycled 10 times
# the server's drills (serve_preprocess flags beside --rm and --rows), each
# counted under its own path.  Both tenants of a drill generate the same
# content, so the second hits the shared cache.  The service drill runs 6
# partitions with pre-warm off: at 4 with pre-warm on, the window pids are
# leased by the other tenant's claims and neither tenant pre-stages, as in
# the reference (tests/test_torch_serve.py::test_drill_sizing_matches_
# reference runs both packages at those flags), so the (d) guard needs the
# window that 6 partitions leave.  The dedup drill runs 8: a block assembly
# needs a pid first claimed after another produce has published its blocks
# (that test holds both packages to block hits at 8).  The fault drill keeps
# the default 6, which read 13 times under its seeded schedule, so
# offline=1@8 fires.  A worker is killed through the service's API after
# the drills (path "service kill"), where its held claim is certain.
SERVICE_DRILLS = (
    ("service", "--jobs 2 --partitions 6 --devices 4 --cache --megabatch 2 --lookahead 2 "
                "--no-prewarm --verify", "mixed"),
    ("service dedup", f"--dup-factor {DEDUP_FACTOR} --dup-pool 16 --cache --jobs 2 "
                      "--partitions 8 --verify", 1),
    ("service faults", "--jobs 2 --cache --io-faults "
                       "transient=0.25,corrupt=0.15,spill=0.4,offline=1@8,seed=13 "
                       "--io-retries 4 --verify", 1),
)
PIPELINE_STEPS = 4  # train steps fed by a service session over the 4 classic files
TRAIN_LR = (3e-4, 2, 100)  # peak, warmup and total steps of the schedule
TRAIN_RANGES = ("dlrm.embedding_bag", "adamw")  # record_function ranges of the port
# the training driver at full width (launch.train --mode recsys): 4 steps fed
# by 2 service workers over 6 source partitions, rm2 and then CKPT_CONFIG with
# its checkpoint.  A call of the GPU machine may write 45 GiB to its disk, and
# rm2's checkpoint alone is 45.11 GiB; rm1's is 27.93 GiB.
DRIVER_PARTITIONS, DRIVER_STEPS = 6, 4
CKPT_CONFIG = "rm1"
# the elastic drill: RM2's feature geometry with tables cut from 500,000 to
# 25,000 rows (205.9M parameters, 2.47 GB checkpoints, written 3 times), 4
# steps, a failure at 3; the writes of the whole run stay under the disk's cap
ELASTIC_ROWS, ELASTIC_STEPS = 25_000, 4
E2E_STEPS = 40  # train_recsys_e2e's steps on the card
SIM_SEED = 11


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def words(rng, shape, device) -> torch.Tensor:
    """Arbitrary uint32 words (NaN, +-inf and denormals decode from them)."""
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


def sorted_bounds(rng, f, m, device) -> torch.Tensor:
    """Sorted, NaN-free boundaries over the whole float range, with repeats."""
    v = np.sign(rng.standard_normal((f, m))) * 10.0 ** rng.uniform(-40, 38, (f, m))
    v[:, 1::5] = v[:, ::5][:, : v[:, 1::5].shape[1]]
    return torch.from_numpy(np.sort(v.astype(np.float32), axis=-1)).to(device)


def max_abs_err(out: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |out - want| over elements where both are finite (0 for equal
    integers); NaN and inf agreement is checked separately."""
    if out.dtype.is_floating_point:
        both = torch.isfinite(out) & torch.isfinite(want)
        d = (out - want).abs()[both]
        return float(d.max()) if d.numel() else 0.0
    return float((out.to(torch.int64) - want.to(torch.int64)).abs().max()) if out.numel() else 0.0


def hold(name: str, out: torch.Tensor, want: torch.Tensor, errs: dict) -> None:
    """Kernel output against its plain version: bitwise for integers,
    DENSE_TOL for the log-normalized floats."""
    torch.cuda.synchronize()
    if out.dtype.is_floating_point:
        torch.testing.assert_close(out, want, **DENSE_TOL, msg=lambda m: f"{name}: {m}")
    else:
        check(torch.equal(out, want), f"{name}: kernel differs from its plain version")
    errs[name] = max(errs.get(name, 0.0), max_abs_err(out, want))


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    regs = [int(l.split("Used ")[1].split()[0]) for lg in logs.values()
            for l in lg.splitlines() if "Used " in l and " registers" in l]
    spills = [int(l.split("bytes spill stores")[0].split(",")[-1]) for lg in logs.values()
              for l in lg.splitlines() if "bytes spill stores" in l]
    print(f"build: {len(logs)} source(s) with nvcc in {dt:.2f} s; ptxas: "
          f"{len(regs)} kernel entries, max {max(regs, default=0)} registers, "
          f"{sum(spills)} bytes of spill stores")


def phase_kernels(rng, dev, errs: dict) -> None:
    """Every kernel against its plain version on adversarial inputs."""
    from repro_torch.data import encoding as enc
    from repro_torch.kernels import fused, ops, ref

    params = lambda f: ops.hash_params(  # noqa: E731
        rng.integers(0, 2**32, f, dtype=np.uint32),
        rng.integers(1, 2**32, f, dtype=np.uint32), dev)
    cases = 0
    for f, g in DENSE_CASES:
        w = words(rng, (f, g, 4), dev)
        hold("fused_dense", fused.fused_dense(w), ref.fused_dense(w), errs)
        cases += 1
    for f, g, widths in SPARSE_CASES:
        for width in widths:
            w, p = words(rng, (f, g, width), dev), params(f)
            hold("fused_sparse", fused.fused_sparse(w, p, width=width),
                 ref.fused_sparse(w, p, width=width), errs)
            cases += 1
    for f, g, widths in BITPACK_OFFSET_CASES:
        for width in widths:
            w, p = offset_view(rng, (f, g, width), dev), params(f)
            hold("fused_sparse", fused.fused_sparse(w, p, width=width),
                 ref.fused_sparse(w, p, width=width), errs)
            cases += 1
    for f, g, m in GEN_CASES:
        w, p = words(rng, (f, g, 4), dev), params(f)
        b = ops.pad_boundaries(sorted_bounds(rng, f, m, dev), dev)
        hold("fused_gen", fused.fused_gen(w, b, p), ref.fused_gen(w, b, p), errs)
        cases += 1
    for m in UNPADDED_M:
        w, p = words(rng, (3, 130, 4), dev), params(3)
        b = sorted_bounds(rng, 3, m, dev)
        hold("fused_gen", fused.fused_gen(w, b, p), ref.fused_gen(w, b, p), errs)
        cases += 1
    for f, r, m in BUCKET_OFFSET_CASES:
        w, p = words(rng, (f, r // 4, 4), dev), params(f)
        b = offset_copy(ops.pad_boundaries(sorted_bounds(rng, f, m, dev), dev))
        hold("fused_gen", fused.fused_gen(w, b, p), ref.fused_gen(w, b, p), errs)
        cases += 1
    for f, r, m in DEVICE_SEARCH_CASES:
        w, p = words(rng, (f, r // 4, 4), dev), params(f)
        b = sorted_bounds(rng, f, m, dev)
        hold("fused_gen", fused.fused_gen(w, b, p), ref.fused_gen(w, b, p), errs)
        cases += 1

    # C1: +inf counts the +inf padding, NaN counts nothing; subnormal values
    # and boundaries compare as zero, as in the reference
    for vals, bounds, counts in (
        ([np.nan, np.inf, -np.inf, 1.0], [0.5, 1.0, 2.0, 3.0], [0, 128, 0, 2]),
        ([np.nan, np.inf, 0.0, 1e30], list(np.linspace(-1, 1, 1024)), [0, 1024, 512, 1024]),
        ([-5e-40, 5e-40, 1e-45, -0.0], [-1e-39, 0.0, 1e-39, 1.0], [3, 3, 3, 3]),
        # values equal to boundaries, a run of repeats, -0 against +0
        ([1.0, 2.0, -0.0, 0.0], [-1e-39, -0.0, 0.0, 1.0, 1.0, 1.0, 2.0], [6, 7, 3, 3]),
    ):
        planes, _ = enc.bytesplit_encode(np.asarray(vals, np.float32))
        w = ops.as_words(ops.regroup_bytesplit(planes, 4)[None]).to(dev)
        b = ops.pad_boundaries(np.asarray([bounds], np.float32), dev)
        p = ops.hash_params([12345], [2**32 - 1], dev)
        out = fused.fused_gen(w, b, p).reshape(-1)
        want = ref.sigridhash(torch.tensor(counts, device=dev), 12345, 2**32 - 1)
        check(torch.equal(ref.fused_gen(w, b, p).reshape(-1), want), "plain C1 counts")
        hold("fused_gen", out, want, errs)
        cases += 1
    # C5: NaN survives max(x, 0); negatives and -inf go to 0
    planes, _ = enc.bytesplit_encode(np.asarray([np.nan, -1.0, -np.inf, np.inf], np.float32))
    w = ops.as_words(ops.regroup_bytesplit(planes, 4)[None]).to(dev)
    out = fused.fused_dense(w).reshape(-1).cpu()
    check(bool(torch.isnan(out[0])), "fused_dense lost the NaN")
    check(out[1:].tolist() == [0.0, 0.0, float("inf")], f"fused_dense edge values {out}")
    hold("fused_dense", fused.fused_dense(w), ref.fused_dense(w), errs)
    cases += 1
    print(f"kernels: {cases} cases, every kernel equals its plain version "
          f"(integers bitwise, dense rtol=atol=1e-6 with NaN equal)")


def hold_bits(name: str, out: torch.Tensor, want: torch.Tensor, errs: dict) -> None:
    """A decode against its plain version bit for bit, through int32 views
    (``torch.equal`` on floats fails on NaN; a tolerance would hide a
    changed payload)."""
    torch.cuda.synchronize()
    check(out.shape == want.shape and out.dtype == want.dtype, f"{name}: shape/dtype")
    check(torch.equal(out.view(torch.int32), want.view(torch.int32)),
          f"{name}: bits differ from the plain version")
    errs.setdefault(name, 0.0)


def offset_view(rng, shape, device) -> torch.Tensor:
    """Arbitrary words as a contiguous view 4 bytes past a 16-byte aligned
    buffer start, so 16-byte vector accesses are not allowed."""
    return offset_copy(words(rng, shape, device))


def offset_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` 4 bytes past 16-byte alignment."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    shift = (4 - buf.data_ptr()) % 16 // 4
    v = buf[shift:shift + t.numel()].view(t.shape)
    v.copy_(t)
    check(v.data_ptr() % 16 == 4 and v.is_contiguous(), "offset copy layout")
    return v


def phase_standalone_kernels(rng, dev, errs: dict) -> None:
    """The five standalone kernels of the host lowering against their plain
    versions, and the fused chains against their unfused compositions."""
    from repro_torch.kernels import bucketize, decode, fused, lognorm, ops, ref, sigridhash

    params = lambda f: ops.hash_params(  # noqa: E731
        rng.integers(0, 2**32, f, dtype=np.uint32),
        rng.integers(1, 2**32, f, dtype=np.uint32), dev)
    cases = 0
    for f, g, widths in BITUNPACK_CASES:
        for width in widths:
            w = words(rng, (f, g, width), dev)
            hold("bitunpack", decode.bitunpack(w, width=width),
                 ref.bitunpack_grouped(w, width), errs)
            cases += 1
    for f, g, widths in BITPACK_OFFSET_CASES:
        for width in widths:
            w = offset_view(rng, (f, g, width), dev)
            hold("bitunpack", decode.bitunpack(w, width=width),
                 ref.bitunpack_grouped(w, width), errs)
            cases += 1
    for f, g in BYTESPLIT_CASES:
        w = words(rng, (f, g, 4), dev)
        hold_bits("bytesplit", decode.bytesplit(w), ref.bytesplit_decode_grouped(w), errs)
        cases += 1
    w = offset_view(rng, (3, 130, 4), dev)
    hold_bits("bytesplit", decode.bytesplit(w), ref.bytesplit_decode_grouped(w), errs)
    cases += 1
    for f, n in HASH_CASES:
        v, p = words(rng, (f, n), dev), params(f)
        hold("sigridhash", sigridhash.sigridhash(v, p), ref.sigridhash_params(v, p), errs)
        cases += 1
    v, p = offset_view(rng, (3, 1500), dev), params(3)
    hold("sigridhash", sigridhash.sigridhash(v, p), ref.sigridhash_params(v, p), errs)
    cases += 1
    for f, r, m in BUCKETIZE_CASES:
        x = words(rng, (f, r), dev).view(torch.float32)
        b = ops.pad_boundaries(sorted_bounds(rng, f, m, dev), dev)
        hold("bucketize", bucketize.bucketize(x, b), ref.bucketize(x, b), errs)
        cases += 1
    for m in UNPADDED_M:
        x = words(rng, (3, 1501), dev).view(torch.float32)
        b = sorted_bounds(rng, 3, m, dev)
        hold("bucketize", bucketize.bucketize(x, b), ref.bucketize(x, b), errs)
        cases += 1
    for f, r, m in BUCKET_OFFSET_CASES:
        x = offset_view(rng, (f, r), dev).view(torch.float32)
        b = ops.pad_boundaries(sorted_bounds(rng, f, m, dev), dev)
        for bb in (b, offset_copy(b)):
            hold("bucketize", bucketize.bucketize(x, bb), ref.bucketize(x, bb), errs)
            cases += 1
    for f, r, m in DEVICE_SEARCH_CASES:
        x = words(rng, (f, r), dev).view(torch.float32)
        b = sorted_bounds(rng, f, m, dev)
        x[:, :64] = b[:, ::max(m // 64, 1)][:, :64]  # values on boundaries
        hold("bucketize", bucketize.bucketize(x, b), ref.bucketize(x, b), errs)
        cases += 1
    for shape in LOGNORM_CASES:
        x = words(rng, shape, dev).view(torch.float32)
        hold("lognorm", lognorm.lognorm(x), ref.lognorm(x), errs)
        cases += 1
    x = offset_view(rng, (1027,), dev).view(torch.float32)
    hold("lognorm", lognorm.lognorm(x), ref.lognorm(x), errs)
    cases += 1

    # C1 and C6 through the standalone Bucketize (padded to 128 by ops)
    for vals, bounds, counts in (
        ([np.nan, np.inf, -np.inf, 1.0], [0.5, 1.0, 2.0, 3.0], [0, 128, 0, 2]),
        ([np.nan, np.inf, 0.0, 1e30], list(np.linspace(-1, 1, 1024)), [0, 1024, 512, 1024]),
        ([-5e-40, 5e-40, 1e-45, -0.0], [-1e-39, 0.0, 1e-39, 1.0], [3, 3, 3, 3]),
        # values equal to boundaries, a run of repeats, -0 against +0
        ([1.0, 2.0, -0.0, 0.0], [-1e-39, -0.0, 0.0, 1.0, 1.0, 1.0, 2.0], [6, 7, 3, 3]),
    ):
        x = torch.tensor([vals], dtype=torch.float32, device=dev)
        b = ops.pad_boundaries(np.asarray([bounds], np.float32), dev)
        want = torch.tensor([counts], dtype=torch.int32, device=dev)
        check(torch.equal(ref.bucketize(x, b), want), "plain C1/C6 counts")
        hold("bucketize", bucketize.bucketize(x, b), want, errs)
        cases += 1
    # C5 through the standalone Log
    x = torch.tensor([np.nan, -1.0, -np.inf, np.inf, 0.0], dtype=torch.float32, device=dev)
    out = lognorm.lognorm(x).cpu()
    check(bool(torch.isnan(out[0])), "lognorm lost the NaN")
    check(out[1:].tolist() == [0.0, 0.0, float("inf"), 0.0], f"lognorm edge values {out}")
    hold("lognorm", lognorm.lognorm(x), ref.lognorm(x), errs)
    cases += 1

    # fused chains equal their unfused compositions of kernels, bit for bit
    w = words(rng, (504, 2048, 4), dev)
    torch.testing.assert_close(fused.fused_dense(w), lognorm.lognorm(decode.bytesplit(w)),
                               rtol=0, atol=0, equal_nan=True)
    w, p = words(rng, (42, 2048, 24), dev), params(42)
    check(torch.equal(fused.fused_sparse(w, p, width=24).reshape(42, -1),
                      sigridhash.sigridhash(decode.bitunpack(w, width=24).reshape(42, -1), p)),
          "fused_sparse differs from bitunpack -> sigridhash")
    w, p = words(rng, (21, 2048, 4), dev), params(21)
    b = ops.pad_boundaries(sorted_bounds(rng, 21, 1024, dev), dev)
    x = decode.bytesplit(w).reshape(21, -1)
    check(torch.equal(fused.fused_gen(w, b, p).reshape(21, -1),
                      sigridhash.sigridhash(bucketize.bucketize(x, b), p)),
          "fused_gen differs from bytesplit -> bucketize -> sigridhash")
    torch.cuda.synchronize()
    cases += 3
    print(f"standalone kernels: {cases} cases, every kernel equals its plain version "
          f"(integers bitwise, decodes bitwise through int32 views, lognorm rtol=atol=1e-6 "
          f"with NaN equal); the 3 fused chains equal their unfused kernel chains bitwise")


def path_totals(by_k: dict) -> dict:
    """One path's launch counts summed over its megabatch sizes."""
    names = next(iter(by_k.values()))
    return {name: sum(counts[name] for counts in by_k.values()) for name in names}


def check_launches(path: str, plan, by_k: dict) -> None:
    """Every kernel the plan's stages run was launched on this path, and no
    other kernel was."""
    want = {STAGE_KERNELS[st.kind] for st in plan.stages if st.kind in STAGE_KERNELS}
    for name, n in path_totals(by_k).items():
        if name in want:
            check(n > 0, f"{path}: {name} was never launched")
        else:
            check(n == 0, f"{path}: {name} launched {n} times, but is not in the plan")


def phase_main_path(dev):
    """rm2 at full width through TorchPreStoEngine.produce_stream."""
    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.data.synth import make_rm_source
    from repro_torch.kernels import fused

    src = make_rm_source(MAIN_CONFIG, rows=MAIN_ROWS, seed=0)
    spec = TransformSpec.from_source(src)
    store = PartitionedStore(8, num_devices=4, source=src)
    engine = TorchPreStoEngine(spec)
    rows = src.rows

    # the counts are read per megabatch size, so each lands on its own shape
    launches = {}
    fused.reset_launches()
    t0 = time.perf_counter()
    first = list(engine.produce_stream(store, range(4)))
    t1 = time.perf_counter()
    launches[1] = dict(fused.LAUNCHES)
    fused.reset_launches()
    second = list(engine.produce_stream(store, range(4, 8), megabatch=2))
    t2 = time.perf_counter()
    launches[2] = dict(fused.LAUNCHES)
    print(f"main path (presto): {MAIN_CONFIG} rows={rows}, 8 partitions, launches at "
          f"megabatch 1 {launches[1]}, at megabatch 2 {launches[2]}")
    check_launches("presto", engine.lowered_plan, launches)
    delivered = first + second
    check([pid for pid, _ in delivered] == list(range(8)), "pids out of order")
    print(f"main path: delivered {4 * rows / (t1 - t0):.1f} samples/s at megabatch 1, "
          f"{4 * rows / (t2 - t1):.1f} samples/s at megabatch 2 (overlap on, wall clock)")

    plain = TorchPreStoEngine(spec, device="cpu")
    for pid, mb in delivered:
        want = plain.produce_batch(store, pid)
        for key, v in want.items():
            got = mb[key].cpu()
            check(got.shape == v.shape and got.dtype == v.dtype, f"{key} shape/dtype")
            if key == "dense":
                torch.testing.assert_close(got, v, **DENSE_TOL)
            else:
                check(torch.equal(got, v), f"pid {pid} {key} differs from the plain path")
        cfg = spec.cfg
        check(mb["dense"].shape == (rows, cfg.n_dense)
              and mb["multi_hot_ids"].shape == (rows, cfg.n_sparse, cfg.max_sparse_len),
              "batch shapes")
    print("main path: 8 batches equal the plain path (integers and labels bitwise, "
          "dense rtol=atol=1e-6)")
    return engine, store, launches, dict(delivered)


def phase_host_paths(spec, store, fused_batches: dict) -> dict:
    """The unfused (Disagg) and hybrid lowerings at rm2 over the same store,
    each batch held bitwise against the fused batch of its pid."""
    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.kernels import fused

    paths = (
        ("unfused", dict(placement="disagg", kernel_mode="unfused"), range(4), 1),
        ("hybrid", dict(placement="hybrid"), range(4, 8), 2),
    )
    engines, by_path = {}, {}
    for name, kwargs, pids, k in paths:
        engine = TorchPreStoEngine(spec, **kwargs)
        engines[name] = engine
        fused.reset_launches()
        t0 = time.perf_counter()
        out = list(engine.produce_stream(store, pids, megabatch=k))
        dt = time.perf_counter() - t0
        by_path[name] = {k: dict(fused.LAUNCHES)}
        check_launches(name, engine.lowered_plan, by_path[name])
        check([pid for pid, _ in out] == list(pids), f"{name}: pids out of order")
        for pid, mb in out:
            want = fused_batches[pid]
            check(set(mb) == set(want), f"{name}: batch keys")
            for key, v in want.items():
                if key == "dense":
                    torch.testing.assert_close(mb[key], v, rtol=0, atol=0, equal_nan=True,
                                               msg=lambda m: f"{name} pid {pid} dense: {m}")
                else:
                    check(torch.equal(mb[key], v), f"{name} pid {pid} {key} differs from fused")
        print(f"path {name}: {kwargs}, host families {engine.host_families()}, stages "
              f"{[st.name for st in engine.lowered_plan.stages]}")
        print(f"path {name}: pids {list(pids)} at megabatch {k}, launches {by_path[name]}, "
              f"{len(out) * store.source.rows / dt:.1f} samples/s (wall clock); "
              f"{len(out)} batches bitwise equal to the fused path's, dense included")
    del out
    return engines, by_path


def phase_dedup(dev):
    """Sample-level dedup (RecD) at full rm2 width: a store whose every 4
    rows share one sparse block (8,192 rows, u = 2,048 unique blocks), four
    partitions through ``produce_stream`` under presto at megabatch 1 and 2,
    unfused at 1 and hybrid at 2.  Every batch must equal, bit for bit
    (dense to DENSE_TOL), the fused batch of its partition inflated to the
    classic layout, on the card, and the plain path on the CPU.  Returns the
    engines, the launch counts by path and megabatch, and one partition's
    staged dedup pages on the card."""
    import dataclasses

    from repro_torch.core.preprocess import pages_from_partition
    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.columnar import inflate_partition
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.data.synth import RM_CONFIGS, SyntheticRecSysSource
    from repro_torch.kernels import fused

    cfg = dataclasses.replace(RM_CONFIGS[MAIN_CONFIG], dup_factor=DEDUP_FACTOR)
    src = SyntheticRecSysSource(cfg, rows=MAIN_ROWS, seed=0)
    spec = TransformSpec.from_source(src)
    store = PartitionedStore(4, num_devices=4, source=src)
    rows, u = src.rows, src.schema.unique_rows
    plain = TorchPreStoEngine(spec, device="cpu")
    want_plain = {pid: plain.produce_batch(store, pid) for pid in range(4)}
    presto = TorchPreStoEngine(spec)
    want_inflated = {}
    for pid in range(4):
        flat = pages_from_partition(inflate_partition(store.read(pid)), spec)
        check("sparse_refs" not in flat, "inflated pages carry refs")
        want_inflated[pid] = presto.preprocess_local(presto.put_pages(presto.pin_pages(flat)))
    print(f"dedup: {MAIN_CONFIG} rows={rows}, dup_factor={DEDUP_FACTOR}, u={u} unique blocks "
          f"per partition; stored {store.read(0).nbytes()} bytes per partition against "
          f"{inflate_partition(store.read(0)).nbytes()} inflated")
    paths = (("presto", {}, 1), ("presto", {}, 2),
             ("unfused", dict(placement="disagg", kernel_mode="unfused"), 1),
             ("hybrid", dict(placement="hybrid"), 2))
    engines, by_path = {"presto": presto}, {}
    for name, kwargs, k in paths:
        engine = engines.setdefault(name, TorchPreStoEngine(spec, **kwargs))
        fused.reset_launches()
        t0 = time.perf_counter()
        out = list(engine.produce_stream(store, range(4), megabatch=k))
        dt = time.perf_counter() - t0
        by_path.setdefault(name, {})[k] = dict(fused.LAUNCHES)
        check([pid for pid, _ in out] == list(range(4)), f"dedup {name}: pids out of order")
        for pid, mb in out:
            for key, v in want_plain[pid].items():
                got = mb[key]
                check(got.shape == v.shape and got.dtype == v.dtype, f"dedup {key} shape/dtype")
                if key == "dense":
                    torch.testing.assert_close(got.cpu(), v, **DENSE_TOL)
                    torch.testing.assert_close(got, want_inflated[pid][key], rtol=0, atol=0,
                                               equal_nan=True)
                else:
                    check(torch.equal(got.cpu(), v), f"dedup {name} pid {pid} {key} != plain")
                    check(torch.equal(got, want_inflated[pid][key]),
                          f"dedup {name} pid {pid} {key} != the inflated partition's batch")
        print(f"dedup path {name}: megabatch {k}, launches {by_path[name][k]}, "
              f"{len(out) * rows / dt:.1f} samples/s (wall clock); 4 batches equal the "
              f"inflated partitions' fused batches and the plain path")
    for name, engine in engines.items():
        check_launches(f"dedup {name}", engine.lowered_plan, by_path[name])
    # one partition's staged pages as a megabatch of 1, for profile_transform
    pages = presto.put_pages(presto.pin_pages(presto.stage_megabatch(store, [0])))
    check(pages["sparse_words"].shape[2] == u * spec.cfg.max_sparse_len // 32
          and tuple(pages["sparse_refs"].shape) == (1, rows), "dedup pages not at unique geometry")
    return engines, by_path, pages


def loader_pass(engine, store, pids):
    """``PrefetchLoader`` (2 workers, depth 2) over ``engine.produce_batch``;
    returns the batches by pid and the launch counts."""
    from repro_torch.data.loader import PrefetchLoader
    from repro_torch.kernels import fused

    fused.reset_launches()
    loader = PrefetchLoader(pids, lambda pid: engine.produce_batch(store, pid),
                            num_workers=2, depth=2)
    try:
        got = dict(loader)
    finally:
        loader.stop()
    counts = dict(fused.LAUNCHES)
    check(not any(t.is_alive() for t in loader._threads), "loader threads outlived stop()")
    check(sorted(got) == list(pids), f"loader delivered {sorted(got)}")
    return got, counts


def loader_rate(engine, store, pids, want: dict, cycles: int) -> float:
    """Delivered samples/s of ``PrefetchLoader`` (2 workers, depth 2) over
    `pids` cycled `cycles` times, wall clock; each batch is held bitwise to
    ``want`` as it arrives and then dropped."""
    from repro_torch.data.loader import PrefetchLoader

    pids = list(pids)
    n = len(pids) * cycles
    t0 = time.perf_counter()
    loader = PrefetchLoader(range(n), lambda i: engine.produce_batch(store, pids[i % len(pids)]),
                            num_workers=2, depth=2)
    seen = 0
    try:
        for i, batch in loader:
            check_batch(f"loader item {i}", batch, want[pids[i % len(pids)]])
            seen += 1
    finally:
        loader.stop()
    dt = time.perf_counter() - t0
    check(seen == n and not any(t.is_alive() for t in loader._threads),
          f"loader delivered {seen} of {n}")
    return n * store.source.rows / dt


def check_batch(name: str, got: dict, want: dict) -> None:
    """Bitwise, dense included: the same kernels on the same pages."""
    check(set(got) == set(want), f"{name}: batch keys")
    for key, v in want.items():
        check(got[key].dtype == v.dtype and torch.equal(got[key], v), f"{name}: {key} differs")


def phase_store(dev, engine, fused_batches: dict, root: Path):
    """The file-backed, fault-checked store and the feature cache at full
    rm2 width.  Materializes 4 classic partitions (the main path's pids 0-3)
    and 4 dedup partitions (dup 4) as files under `root`, times
    host staging in three parts (generation, the file read, page build and
    pin), produces through ``PrefetchLoader`` over the files and over the
    source, runs the feature cache through eviction, spill and promotion,
    assembles every dedup partition from its cached blocks, and drives the
    fault domain: a seeded transient spec, a torn read and an out-of-range
    dedup ref (C9).  Returns the launch counts of the loader and assembly
    paths."""
    import dataclasses

    from repro_torch.core.featcache import (
        BlockKey, CacheKey, FeatureCache, batch_nbytes, default_spill_store)
    from repro_torch.core.preprocess import pages_from_partition
    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.columnar import (
        REFS_COLUMN, EncodedColumn, Partition, partition_digest, write_partition)
    from repro_torch.data.storage import (
        CorruptPartitionError, IoFaultInjector, PartitionedStore, TransientReadError,
        parse_iofault_spec)
    from repro_torch.data.synth import RM_CONFIGS, SyntheticRecSysSource
    from repro_torch.kernels import fused

    spec, pids = engine.spec, range(4)
    src = SyntheticRecSysSource(RM_CONFIGS[MAIN_CONFIG], rows=MAIN_ROWS, seed=0)
    dcfg = dataclasses.replace(RM_CONFIGS[MAIN_CONFIG], dup_factor=DEDUP_FACTOR)
    dsrc = SyntheticRecSysSource(dcfg, rows=MAIN_ROWS, seed=0)
    dengine = TorchPreStoEngine(TransformSpec.from_source(dsrc))
    by_path = {}
    fstore = PartitionedStore(4, 4, src, root=str(root / "classic"))
    dstore = PartitionedStore(4, 4, dsrc, root=str(root / "dedup"))
    t0 = time.perf_counter()
    fstore.materialize(pids)
    dstore.materialize(pids)
    files = sorted(root.rglob("*.rp"))
    check(len(files) == 8, f"{len(files)} partition files")
    print(f"store: materialized 4 classic and 4 dedup rm2 partitions "
          f"({sum(f.stat().st_size for f in files)} bytes in 8 files, written with "
          f"write_partition) in {time.perf_counter() - t0:.2f} s")

    # host staging in three parts, host clock, mean over the 4 partitions
    split = {"generation": [], "file read": [], "page build": [], "pin": []}
    for pid in pids:
        t0 = time.perf_counter()
        generated = src.partition(pid)
        t1 = time.perf_counter()
        part = fstore.read(pid)
        t2 = time.perf_counter()
        pages = pages_from_partition(part, spec)
        t3 = time.perf_counter()
        engine.pin_pages(pages)
        t4 = time.perf_counter()
        check(partition_digest(part) == partition_digest(generated),
              f"pid {pid}: the file's pages differ from the source's")
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            split[key].append(dt)
    mean = {k: statistics.mean(v) for k, v in split.items()}
    print("store: host staging per rm2 partition (host clock, mean of 4): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in mean.items())
          + f"; file read + page build + pin {sum(mean.values()) - mean['generation']:.4f} s "
          f"against generation + page build + pin {sum(mean.values()) - mean['file read']:.4f} s")

    # produce through the loader over the files: the counted pass, then
    # the rate over many produces, and the source's rate beside it
    got, counts = loader_pass(engine, fstore, pids)
    by_path["store presto"] = {1: counts}
    check_launches("store presto", engine.lowered_plan, by_path["store presto"])
    for pid in pids:
        check_batch(f"store pid {pid} (file)", got[pid], fused_batches[pid])
    file_rates = [loader_rate(engine, fstore, pids, fused_batches, LOADER_CYCLES)
                  for _ in range(LOADER_RUNS)]
    src_rate = loader_rate(engine, PartitionedStore(4, 4, src), pids, fused_batches, 2)
    print(f"store: PrefetchLoader (2 workers, depth 2) under presto, wall clock, after a "
          f"warm pass: from the files {LOADER_RUNS} runs of {4 * LOADER_CYCLES} produces "
          f"(the 4 pids cycled {LOADER_CYCLES} times) delivered "
          + ", ".join(f"{r:.1f}" for r in file_rates)
          + f" samples/s (median {statistics.median(file_rates):.1f}, spread "
          f"{(max(file_rates) - min(file_rates)) / statistics.median(file_rates):.3f} of it); "
          f"from the synthetic source 8 produces delivered {src_rate:.1f} samples/s; "
          f"launches of the counted pass {counts}; every batch bitwise the main path's")

    # the feature cache: capacity 2 batches, eviction spills, spill hits promote
    one = batch_nbytes(got[0])
    check(one == sum(v.numel() * v.element_size() for v in got[0].values()) > 0,
          "batch_nbytes of a device batch")
    spill = default_spill_store(4)
    cache = FeatureCache(2 * one, spill=spill, device=dev)
    keys = {pid: CacheKey(fstore.partition_fingerprint(pid), engine.cache_signature(),
                          engine.placement) for pid in pids}
    for pid in pids:
        status, _ = cache.begin(keys[pid])
        check(status == "produce", f"cache pid {pid}: cold probe {status}")
        cache.fulfill(keys[pid], got[pid])
    st = cache.stats()
    check(st.evictions == 2 and len(spill) == 2 and st.resident_bytes == 2 * one,
          f"cache after the cold pass: {st}")
    t0 = time.perf_counter()
    for pid in pids:
        status, hit = cache.begin(keys[pid])
        check(status == "hit", f"cache pid {pid}: second pass {status}")
        check(all(v.device == dev for v in hit.values()), "a hit left the card")
        check_batch(f"cache hit pid {pid}", hit, fused_batches[pid])
    dt_hits = time.perf_counter() - t0
    status, hit = cache.begin(keys[3])  # just promoted: a memory hit
    check(status == "hit" and all(hit[k] is v for k, v in cache.get(keys[3]).items()),
          "a memory hit copied the batch")
    st = cache.stats()
    check(st.hits == 6 and st.spill_hits == 4 and st.misses == 4
          and st.resident_bytes == 2 * one and st.entries == 2,
          f"cache after the second pass: {st}")
    resident = torch.cuda.memory_allocated(dev)
    print(f"store: feature cache of 2 batches ({2 * one} device bytes resident, "
          f"{one} per batch by numel * element_size; memory_allocated {resident}); "
          f"second pass {st.hits - 2} hits ({st.spill_hits} spill hits promoted to the "
          f"card) in {dt_hits:.3f} s, evictions {st.evictions}, spilled {st.spilled_entries} "
          f"blocks of {st.spilled_bytes} bytes; every hit bitwise the cold batch")
    del cache, spill, hit

    # block assembly: extract -> put_block -> assemble_from_blocks on the card
    bcache = FeatureCache(2 * one, device=dev)
    assembled, dcold, walls = {}, {}, {"assemble": [], "cold": []}
    for pid in pids:
        cold = dcold[pid] = dengine.produce_batch(dstore, pid)
        refs, fps = dstore.block_refs(pid), dstore.block_fingerprints(pid)
        ids, lens = dengine.extract_blocks(cold, refs)
        bkeys = [BlockKey(fp, dengine.cache_signature(), dengine.placement) for fp in fps]
        for key, i, n in zip(bkeys, ids, lens):
            bcache.put_block(key, i, n)
        blocks = bcache.get_blocks(bkeys)
        check(blocks is not None, f"dedup pid {pid}: blocks missing")
        pages = dengine.stage_partition(dstore, pid)
        torch.cuda.synchronize()
        fused.reset_launches()
        t0 = time.perf_counter()
        batch = dengine.assemble_from_blocks(pages, *blocks)
        walls["assemble"].append(time.perf_counter() - t0)
        counts = dict(fused.LAUNCHES)
        t0 = time.perf_counter()  # the whole Transform from the same staged pages
        dengine.preprocess_local(dengine.put_pages(dengine.pin_pages(pages)))
        torch.cuda.synchronize()
        walls["cold"].append(time.perf_counter() - t0)
        assembled[pid] = counts
        check(counts["fused_dense"] == 1 and counts["fused_gen"] == 1
              and sum(counts.values()) == 2, f"assemble pid {pid}: launches {counts}")
        check_batch(f"assembled dedup pid {pid}", batch, cold)
    by_path["assemble"] = {1: {n: sum(c[n] for c in assembled.values())
                               for n in assembled[0]}}
    bst = bcache.stats()
    print(f"store: block assembly of 4 dedup partitions ({len(fps)} blocks each, "
          f"{bst.block_hits} block hits): every batch bitwise its cold produce; the rest "
          f"program launched {by_path['assemble'][1]}; from staged pages, assembly "
          f"{1e3 * statistics.mean(walls['assemble']):.3f} ms against the whole Transform "
          f"{1e3 * statistics.mean(walls['cold']):.3f} ms (host clock, pin and copy-in "
          f"included, mean of 4)")
    del bcache

    # faults: seeded transients retry to the clean bytes
    inj = parse_iofault_spec("transient=0.5,seed=7")
    fault_store = PartitionedStore(4, 4, src, root=str(root / "classic"), fault_injector=inj)
    transients = 0
    for pid in pids:
        for _ in range(32):
            try:
                batch = engine.produce_batch(fault_store, pid)
                break
            except TransientReadError:
                transients += 1
        else:
            check(False, f"pid {pid} never read through transient=0.5")
        check_batch(f"transient pid {pid}", batch, fused_batches[pid])
    check(transients > 0 and inj.summary() == {"transient": transients},
          f"transients {transients}, injected {inj.summary()}")

    # a torn read raises and delivers nothing: no kernel runs
    torn = PartitionedStore(4, 4, src, root=str(root / "classic"),
                            fault_injector=IoFaultInjector(seed=2, corrupt=1.0))
    fused.reset_launches()
    try:
        engine.produce_batch(torn, 1)
        check(False, "a torn read was delivered")
    except CorruptPartitionError as e:
        check(e.retryable and e.pid == 1, f"torn read error {e!r}")
    check(sum(fused.LAUNCHES.values()) == 0, f"a torn read launched {fused.LAUNCHES}")

    # C9: a dedup ref >= u raises on the host; the context survives
    part = dsrc.partition(0)
    u = part.schema.unique_rows
    refs = np.array(part.columns[REFS_COLUMN].pages["refs"], dtype=np.uint32)
    refs[5] = u
    cols = dict(part.columns)
    cols[REFS_COLUMN] = EncodedColumn(part.columns[REFS_COLUMN].schema, {"refs": refs})
    bad_store = PartitionedStore(1, 1, root=str(root / "bad"))
    write_partition(bad_store._path(0), Partition(0, part.schema, cols))
    fused.reset_launches()
    try:
        dengine.produce_batch(bad_store, 0)
        check(False, "a dedup ref >= u was delivered")
    except CorruptPartitionError as e:
        check(not e.retryable and e.pid == 0, f"C9 error {e!r}")
    check(sum(fused.LAUNCHES.values()) == 0, f"the bad ref launched {fused.LAUNCHES}")
    after = dengine.produce_batch(dstore, 0)  # a launch on the same context
    torch.cuda.synchronize()
    check(fused.LAUNCHES["fused_sparse"] == 1, "no kernel ran after the bad ref")
    check_batch("dedup pid 0 after the bad ref", after, dcold[0])
    print(f"store: faults: transient=0.5 (seed 7) retried {transients} read(s) to bitwise "
          f"clean batches; a torn read raised CorruptPartitionError (retryable) with no "
          f"launch; a dedup ref = u raised CorruptPartitionError (not retryable) on the "
          f"host with no launch, and the next produce ran on the same context")
    return by_path


def event_counts(path: Path) -> dict:
    """Event kinds of a ``--events-out`` file, counted."""
    counts = {}
    for ev in json.loads(path.read_text()):
        counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
    return counts


def run_drill(serve_preprocess, argv: list):
    """``serve_preprocess.main(argv)`` with the launch counts of the
    service's own run and of its ``--verify`` recompute read apart: the
    counters are read and zeroed as the verify starts, when every session
    has drained and the pool is closed.  Returns the per-job stats and the
    two counts."""
    from repro_torch.kernels import fused

    real, counts = serve_preprocess.verify_delivered, {}

    def counted(*args, **kwargs):
        counts["service"] = dict(fused.LAUNCHES)
        fused.reset_launches()
        real(*args, **kwargs)
        counts["verify"] = dict(fused.LAUNCHES)

    serve_preprocess.verify_delivered = counted
    try:
        fused.reset_launches()
        stats = serve_preprocess.main(argv)
    finally:
        serve_preprocess.verify_delivered = real
    check(set(counts) == {"service", "verify"}, f"{argv}: the verify did not run")
    return stats, counts["service"], counts["verify"]


def phase_service(engine, files: Path, fused_batches: dict, root: Path) -> dict:
    """The preprocessing service at full rm2 width: the server entry point
    (``serve_preprocess.main``) in-process for each of SERVICE_DRILLS, every
    batch held bitwise against a solo recompute on the card (``--verify``),
    then a worker killed mid-read through the service's own API.  Returns
    each path's launch counts; a drill's path counts only the service's
    own produces, since its verify's solo recomputes are counted apart."""
    from repro_torch.core.service import JobSpec, PreprocessingService
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.kernels import fused
    from repro_torch.launch import serve_preprocess

    rows = engine.spec.cfg.rows_per_partition if MAIN_ROWS is None else MAIN_ROWS
    plan_kernels = {STAGE_KERNELS[st.kind] for st in engine.lowered_plan.stages
                    if st.kind in STAGE_KERNELS}
    by_path = {}
    for path, flags, k in SERVICE_DRILLS:
        events = root / f"events_{path.replace(' ', '_')}.json"
        argv = ["--rm", MAIN_CONFIG, "--rows", str(rows), *flags.split(),
                "--events-out", str(events)]
        print(f"{path}: serve_preprocess {' '.join(argv)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, counts, verify = run_drill(serve_preprocess, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_path[path] = {k: counts}
        check_launches(path, engine.lowered_plan, by_path[path])
        # the verify is one solo produce per (job, pid), each launching every
        # kernel of the plan once
        solo = sum(st.total for st in stats.values())
        check(verify == {n: solo if n in plan_kernels else 0 for n in verify},
              f"{path}: the verify's {solo} solo produces launched {verify}")
        kinds = event_counts(events)
        for name, st in stats.items():
            check(st.done and not st.cancelled and st.delivered == st.total
                  and st.quarantined == 0, f"{path}: {name} ended {st}")
        total = {f: sum(getattr(st, f) for st in stats.values())
                 for f in ("cache_hits", "block_hits", "blocks_published", "reissues",
                           "retries", "failovers")}
        staged = max(st.staged_bytes_peak for st in stats.values())
        rates = ", ".join(f"{name} {st.achieved_samples_per_s:.1f}" for name, st in stats.items())
        print(f"{path}: {wall:.2f} s for the drill and its verify; delivered samples/s per "
              f"tenant (wall clock) {rates}; {total}; staged_bytes_peak {staged}; events "
              f"{kinds}; launches by the service {counts}, by the verify {verify}")
        check(total["cache_hits"] > 0, f"{path}: the second tenant never hit the cache")
        if path == "service":
            # the (d) guard: pages are sized, so the lookahead pre-stages
            check(staged > 0, f"{path}: nothing was pre-staged at lookahead 2")
        if path == "service dedup":
            check(total["block_hits"] > 0, f"{path}: no batch was assembled from blocks")
            # every assembly ran the rest program (fused_dense, fused_gen) and
            # no sparse kernel; every other produce ran all three
            extra = counts["fused_dense"] - counts["fused_sparse"]
            check(extra == total["block_hits"] and counts["fused_gen"] == counts["fused_dense"],
                  f"{path}: {total['block_hits']} assemblies, launches {counts}")
        if path == "service faults":
            check(kinds.get("device_offline") == 1 and total["retries"] > 0,
                  f"{path}: the fault schedule did not fire ({kinds})")
            after = engine.produce_batch(PartitionedStore(4, 4, root=str(files)), 0)
            check_batch("pid 0 after the fault drill", after, fused_batches[0])

    # a worker killed mid-read through the service API: its claim re-issues
    # to a live worker, and the session still delivers the main path's bytes
    class GatedStore(PartitionedStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.caught, self.release, self.holder = threading.Event(), threading.Event(), None
            self._gate = threading.Lock()

        def read(self, pid):
            with self._gate:
                hold = pid == 0 and not self.caught.is_set()
                if hold:
                    self.holder = threading.current_thread().name
                    self.caught.set()
            if hold:
                check(self.release.wait(timeout=60), "the gated read was never released")
            return super().read(pid)

    store = GatedStore(4, 4, root=str(files))
    svc = PreprocessingService(num_workers=3)
    fused.reset_launches()
    try:
        sess = svc.submit(JobSpec(name="kill", partitions=range(4), engine=engine, store=store,
                                  units=3, straggler_timeout=60.0, megabatch=2))
        check(store.caught.wait(timeout=60), "no worker reached the gated read")
        check(svc.kill_worker(int(store.holder.rsplit("-", 1)[1])), "kill_worker refused")
        store.release.set()
        got = {}
        for pid, mb in sess:
            got[pid] = mb
    finally:
        store.release.set()
        svc.close()
    torch.cuda.synchronize()
    kill = dict(fused.LAUNCHES)
    by_path["service kill"] = {"mixed": kill}  # megabatch 2: chunks of K <= 2
    check_launches("service kill", engine.lowered_plan, by_path["service kill"])
    st = sess.stats()
    check(st.done and st.reissues >= 1 and sorted(got) == [0, 1, 2, 3],
          f"kill mid-read: {st}")
    for pid, mb in got.items():
        check_batch(f"kill mid-read pid {pid}", mb, fused_batches[pid])
    print(f"service kill: worker {store.holder} killed mid-read of pid 0 (service API, 3 workers, "
          f"megabatch 2, 4 file partitions): {st.reissues} claim(s) re-issued, every batch "
          f"bitwise the main path's; launches {kill}")
    return by_path


def train_config():
    """The model phase_train drives at full width: rm2 (63 tables of
    500,000 x 128, the paper's MLPs)."""
    from repro_torch.configs.registry import get_recsys

    return get_recsys(MAIN_CONFIG)


def ckpt_config():
    """The model whose full-width checkpoint phase_driver writes and
    phase_restore reads back."""
    from repro_torch.configs.registry import get_recsys

    return get_recsys(CKPT_CONFIG)


def train_setup(cfg, model):
    """AdamW over TRAIN_LR's schedule, the state around `model`, and the
    DLRM's loss."""
    from repro_torch.models import recsys as RS
    from repro_torch.train import adamw, init_state, warmup_cosine

    opt = adamw(warmup_cosine(*TRAIN_LR))
    return opt, init_state(model, opt), (lambda m, b: RS.loss_fn(m, b, cfg))


def phase_train_parity(dev) -> None:
    """The DLRM at reduced width (rm2's MLPs, tables of 1,024 rows) from the
    same weights and the same batches: three train steps on the card and on
    the CPU agree to the tolerances of tests/test_torch_train.py (loss rtol
    1e-5; parameters atol lr/100 but for a 1e-5 share of each leaf, and
    within 2 lr per step everywhere)."""
    from repro_torch.configs.registry import get_recsys
    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.data.synth import SyntheticRecSysSource
    from repro_torch.models import recsys as RS
    from repro_torch.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products, as on the CPU
    cfg = get_recsys(MAIN_CONFIG, reduced=True)
    src = SyntheticRecSysSource(cfg.data, seed=0)
    cpu_engine = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    store = PartitionedStore(3, num_devices=1, source=src)
    batches = [cpu_engine.produce_batch(store, pid) for pid in range(3)]
    tree = RS.params_to_numpy(RS.init_params(torch.Generator().manual_seed(1), cfg, "cpu"))
    runs = {}
    for device in ("cpu", dev):
        opt, state, loss = train_setup(cfg, RS.params_from_numpy(tree, cfg, device))
        step = make_train_step(loss, opt)
        losses = []
        for mb in batches:
            state, metrics = step(state, {k: v.to(device) for k, v in mb.items()})
            losses.append(float(metrics["loss"]))
        runs[str(device)] = (losses, RS.params_to_numpy(state["params"]))
    (cpu_losses, cpu_params), (losses, params) = runs["cpu"], runs[str(dev)]
    check(all(np.isfinite(losses)), f"reduced-width losses {losses}")
    np.testing.assert_allclose(losses, cpu_losses, rtol=1e-5)
    atol, worst = TRAIN_LR[0] / 100, 0.0
    for group, want in cpu_params.items():
        leaves = want.items() if isinstance(want, dict) else [("", want)]
        for name, w in leaves:
            got = params[group][name] if name else params[group]
            d = np.abs(got - w)
            off = int((d > atol).sum())
            check(off <= max(1, int(1e-5 * d.size)) and d.max() <= 2 * TRAIN_LR[0] * 3,
                  f"reduced-width {group}.{name}: {off} of {d.size} past {atol}, max {d.max()}")
            worst = max(worst, float(d.max()))
    print(f"train parity: {cfg.name} (tables {cfg.n_tables} x {cfg.data.embedding_rows} x "
          f"{cfg.emb_dim}), 3 steps of {src.rows} rows on {dev} and on the CPU from the same "
          f"weights: losses {losses} against {cpu_losses} (rtol 1e-5), parameters within "
          f"lr/100 but for noise (largest difference {worst:.3g})")


def phase_train(dev, batches: list, engine, store, files: Path) -> dict:
    """The DLRM at full width on the card: 8 ``make_train_step`` steps with
    AdamW on the main path's 8 delivered batches, then 3
    ``make_train_step_with_ingest`` steps on one staged partition (the
    fused kernels inside the step).  The loss must be finite and fall on the
    repeated partition.  Prints the step time (CUDA events, median), the
    profiler's device time split, samples/s and peak memory.  Then
    ``TrainingPipeline.run_session`` trains on, from the same model and
    state, fed by a service session (2 workers) over the 4 classic rm2
    partition files under `files`: consumer utilization, starved seconds,
    step times and losses.  Frees the model, its gradients and the
    optimizer's moments before it returns the ingest steps' and the
    pipeline's launch counts by path."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.pipeline import TrainingPipeline
    from repro_torch.core.service import JobSpec, PreprocessingService
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.kernels import fused
    from repro_torch.models import recsys as RS
    from repro_torch.train import make_train_step, make_train_step_with_ingest

    cfg = train_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = RS.init_params(torch.Generator().manual_seed(0), cfg, dev)
    opt, state, loss = train_setup(cfg, model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"train: {cfg.name}, {n_params} parameters ({n_params * 4} bytes; tables "
          f"{tuple(model.tables.shape)}), drawn with the AdamW moments allocated in "
          f"{time.perf_counter() - t0:.2f} s")
    step = make_train_step(loss, opt)
    ms, losses = [], []
    for i, mb in enumerate(batches):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if i == len(batches) - 1:  # the last step under the profiler
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, metrics = step(state, mb)
                torch.cuda.synchronize()
        else:
            a.record()
            state, metrics = step(state, mb)
            b.record()
            ms.append((a, b))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in ms]
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"full-width train losses {losses}")
    step_ms = statistics.median(times)
    rows = batches[0]["labels"].shape[0]
    print(f"train: {len(batches)} steps of {rows} rows, losses {losses}")
    print(f"train: step time {step_ms:.3f} ms (CUDA events, median of the {len(times)} "
          f"unprofiled steps; all {[round(t, 3) for t in times]}), {rows / step_ms * 1e3:.1f} "
          f"training samples/s; card {card_line()}")
    busy_ms = train_split(prof)
    if busy_ms is not None:
        print(f"train: device busy {busy_ms:.3f} ms of the {step_ms:.3f} ms median step, idle "
              f"share {max(0.0, 1 - busy_ms / step_ms):.1%} (profiled step against unprofiled "
              f"steps)")

    fused.reset_launches()
    ingest = make_train_step_with_ingest(engine, loss, opt)
    pages = engine.put_pages(engine.pin_pages(engine.stage_partition(store, 0)))
    ingest_losses, ingest_ms = [], []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, metrics = ingest(state, pages)
        b.record()
        ingest_losses.append(metrics["loss"])
        ingest_ms.append((a, b))
    torch.cuda.synchronize()
    ingest_losses = [float(x) for x in ingest_losses]
    launches = dict(fused.LAUNCHES)
    check_launches("ingest", engine.lowered_plan, {1: launches})
    check(all(np.isfinite(ingest_losses)) and ingest_losses[-1] < ingest_losses[0],
          f"ingest losses {ingest_losses} do not fall on the repeated partition")
    peak = torch.cuda.max_memory_allocated()
    print(f"train ingest: 3 steps on pid 0's staged pages, losses {ingest_losses} (falling), "
          f"step times {[round(a.elapsed_time(b), 3) for a, b in ingest_ms]} ms, launches "
          f"{launches}")
    print(f"train: peak memory {peak} bytes ({peak / 2**30:.2f} GiB) of "
          f"{torch.cuda.get_device_properties(dev).total_memory} (max_memory_allocated); "
          f"card {card_line()}")

    # the Fig. 9 loop: the trainer drains a service session over the files
    marks = []

    def timed_step(state, mb):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = step(state, mb)
        b.record()
        marks.append((a, b))
        return out

    torch.cuda.synchronize()
    fused.reset_launches()
    with PreprocessingService(num_workers=2) as svc:
        session = svc.submit(JobSpec(
            name="rm2-files", partitions=range(PIPELINE_STEPS), engine=engine,
            store=PartitionedStore(4, 4, root=str(files)), units=2))
        state, pstats, pmetrics = TrainingPipeline(train_step=timed_step).run_session(
            state, session)
    torch.cuda.synchronize()
    pipe_launches = dict(fused.LAUNCHES)
    check_launches("pipeline", engine.lowered_plan, {1: pipe_launches})
    plosses = [m["loss"] for m in pmetrics]
    check(pstats.steps == PIPELINE_STEPS and all(np.isfinite(plosses)),
          f"pipeline: {pstats.steps} steps, losses {plosses}")
    fed_ms = [a.elapsed_time(b) for a, b in marks]
    print(f"pipeline: TrainingPipeline.run_session over a service session (2 workers, "
          f"{PIPELINE_STEPS} rm2 partition files): {pstats.steps} steps, losses {plosses}; "
          f"consumer utilization {pstats.utilization:.4f}, starved {pstats.starved_time_s:.4f} s, "
          f"train {pstats.train_time_s:.4f} s of {pstats.wall_time_s:.4f} s wall, reissues "
          f"{pstats.reissues}; step times fed by the session {[round(t, 3) for t in fed_ms]} "
          f"ms (CUDA events; median {statistics.median(fed_ms):.3f}) against {step_ms:.3f} ms "
          f"for the direct step above; launches {pipe_launches}; card {card_line()}")
    del model, state, opt, step, ingest, metrics, pages, session, pmetrics
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < 4 << 30, "the trainer's memory was not freed")
    return {"ingest": {1: launches}, "pipeline": {1: pipe_launches}}


def train_split(prof) -> float | None:
    """One train step's device time from the profiler: the embedding bag
    forward (``dlrm.embedding_bag``) and backward, the optimizer
    (``adamw``: global norm, clip and update) and the rest (the MLPs, the
    interaction, the loss, zeroing); returns the busy ms (None if the
    profiler saw no device time)."""
    from torch.autograd import DeviceType

    rows = prof.key_averages()
    # the record_function ranges also show as spans on the device's timeline
    kernels = [(e.key, e.count, e.device_time_total) for e in rows
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0
               and e.key not in TRAIN_RANGES]
    if not kernels:
        print("train split: the profiler saw no device time (not measured)")
        return None
    busy = sum(t for _, _, t in kernels)

    def part(match):
        return sum(e.device_time_total for e in rows
                   if e.device_type == DeviceType.CPU and match(e.key))

    emb_f = part(lambda k: k == "dlrm.embedding_bag")
    # the autograd engine's span of the node holds the node's own span
    emb_b = part(lambda k: k.startswith("autograd::engine::evaluate_function: "
                                        "EmbeddingBagBackward"))
    opt = part(lambda k: k == "adamw")
    rest = busy - emb_f - emb_b - opt
    print(f"train split (profiler, one step): device busy {busy / 1e3:.3f} ms; embedding "
          f"forward {emb_f / 1e3:.3f} ms, embedding backward {emb_b / 1e3:.3f} ms, MLPs + "
          f"interaction + loss {rest / 1e3:.3f} ms, optimizer {opt / 1e3:.3f} ms")
    for key, count, t in sorted(kernels, key=lambda r: -r[2])[:12]:
        print(f"train split:   {t / 1e3:9.3f} ms  x{count}  {key[:90]}")
    return busy / 1e3


def host_free_bytes() -> int:
    """The host's available memory (``MemAvailable``), in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise SmokeFailure("no MemAvailable in /proc/meminfo")


def state_bytes(cfg) -> int:
    """Bytes of a checkpoint of `cfg`'s TrainState: parameters and the two
    AdamW moments in f32, the optimizer's count and the step (int32)."""
    from repro_torch.models import recsys as RS

    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        return int(np.prod(node.shape)) * 4

    return 3 * walk(RS.model_schema(cfg)) + 8


def run_driver(engine, rm: str, ckpt_dir: Path | None) -> dict:
    """``repro_torch.launch.train.main`` as a user runs it: `rm` at full
    width, DRIVER_PARTITIONS source partitions served by 2 service workers,
    presto placement, DRIVER_STEPS steps, and a checkpoint in `ckpt_dir`
    when one is given.  Checks the steps, the losses and the path's
    launches; returns the driver's dict and the launch counts."""
    from repro_torch.kernels import fused
    from repro_torch.launch import train as driver

    argv = ["--mode", "recsys", "--rm", rm, "--rows", str(MAIN_ROWS or 8192),
            "--partitions", str(DRIVER_PARTITIONS), "--steps", str(DRIVER_STEPS),
            "--workers", "2", "--placement", "presto"]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", str(ckpt_dir)]
    torch.cuda.empty_cache()
    fused.reset_launches()
    t0 = time.perf_counter()
    out = driver.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    check_launches(f"driver {rm}", engine.lowered_plan, {1: launches})
    check(out["steps"] == DRIVER_STEPS and len(out["losses"]) == DRIVER_STEPS
          and all(np.isfinite(out["losses"])), f"driver: {out['steps']} steps, {out['losses']}")
    print(f"driver: {' '.join(argv)}: {out['steps']} steps, losses {out['losses']}, step "
          f"times {[round(t, 3) for t in out['step_ms']]} ms (CUDA events), launches "
          f"{launches}, {wall:.2f} s in all; card {card_line()}")
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < 4 << 30, "the driver's state was not freed")
    return out, launches


def phase_driver(engine, ckpt_dir: Path) -> dict:
    """The training driver at full width: rm2 (63 x 500,000 x 128 tables,
    4,036,325,249 parameters) for DRIVER_STEPS steps, then rm1 (39 x
    500,000 x 128) with its checkpoint in `ckpt_dir`.  The rm2 state's
    checkpoint (48,435,902,996 bytes, 45.11 GiB) is more than the 45 GiB a
    call of the GPU machine may write to its disk, so the full-width
    checkpoint is rm1's (29,985,698,316 bytes).  Fails, with the numbers,
    when the checkpoint's filesystem or the host has less free than it
    takes.  Returns each run's launch counts by path."""
    _, rm2 = run_driver(engine, MAIN_CONFIG, None)
    need = state_bytes(ckpt_config())
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    disk, ram = shutil.disk_usage(ckpt_dir).free, host_free_bytes()
    print(f"driver: the {CKPT_CONFIG} checkpoint needs {need} bytes; free on its filesystem "
          f"{disk} bytes, host memory available {ram} bytes")
    check(disk >= need and ram >= need,
          f"driver: {need} bytes needed, {disk} free on disk and {ram} in host memory")
    out, rm1 = run_driver(engine, CKPT_CONFIG, ckpt_dir)
    saved = out["checkpoint"]
    check(saved["bytes"] == need, f"driver: checkpoint of {saved['bytes']} bytes, want {need}")
    print(f"driver: checkpoint of {CKPT_CONFIG} step {saved['step']}, {saved['bytes']} bytes "
          f"({saved['bytes'] / 1e9:.2f} GB): host snapshot {saved['snapshot_s']:.3f} s "
          f"({saved['bytes'] / 1e9 / saved['snapshot_s']:.3f} GB/s), write "
          f"{saved['write_s']:.3f} s ({saved['bytes'] / 1e9 / saved['write_s']:.3f} GB/s); "
          f"card {card_line()}")
    return {f"driver {MAIN_CONFIG}": {1: rm2}, f"driver {CKPT_CONFIG}": {1: rm1}}


def phase_restore(dev, ckpt_dir: Path) -> None:
    """The driver's checkpoint restored in place at full width: a state of
    the same structure, zeroed, takes the checkpoint leaf by leaf
    (``CheckpointManager.restore``); every leaf is then held bitwise against
    its ``.npy``, chunk by chunk.  The peak of ``max_memory_allocated``
    during the restore stays within 1 GiB of the state's own bytes."""
    from repro_torch.launch import train as driver
    from repro_torch.models import recsys as RS
    from repro_torch.train import CheckpointManager, init_state
    from repro_torch.train.checkpoint import flatten_state, leaf_chunks

    cfg = ckpt_config()
    ck = CheckpointManager(str(ckpt_dir))
    step = ck.latest_step()
    check(step == DRIVER_STEPS, f"restore: latest step {step}")
    opt, _ = driver.recsys_step(cfg, 1e-3, DRIVER_STEPS)
    state = init_state(RS.init_params(torch.Generator().manual_seed(1), cfg, dev), opt)
    with torch.no_grad():
        for _, t in flatten_state(state):
            t.zero_()
    nbytes = sum(t.numel() * t.element_size() for _, t in flatten_state(state))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ck.restore(step, target=state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t1, chunks = time.perf_counter(), 0
    for name, arr, dst in ck.open_leaves(step, state):
        for src, out in leaf_chunks(arr, dst):
            check(torch.equal(out, torch.from_numpy(np.array(src)).to(dev)),
                  f"restore: {name} differs from its .npy")
            chunks += 1
    verify_s = time.perf_counter() - t1
    print(f"restore: {cfg.name} step {step}, {nbytes} bytes ({nbytes / 1e9:.2f} GB) into a "
          f"zeroed state in place in {dt:.3f} s ({nbytes / 1e9 / dt:.3f} GB/s); every leaf "
          f"bitwise its .npy ({chunks} chunks, {verify_s:.3f} s); max_memory_allocated during "
          f"the restore {peak} bytes, the state {nbytes}, other live allocations "
          f"{base - nbytes}, peak above the state {peak - nbytes} bytes; card {card_line()}")
    check(peak <= nbytes + (1 << 30), f"restore: peak {peak} is more than 1 GiB above the "
          f"state's {nbytes} bytes")
    del state, opt
    torch.cuda.empty_cache()


def phase_elastic(dev, ckpt_dir: Path) -> dict:
    """``ElasticTrainer`` over the driver's step at RM2's feature geometry
    with tables cut to ELASTIC_ROWS rows: checkpoints every 2 steps, a
    failure at step 3, then a second incarnation that restores step 2 and
    finishes at step 4.  The failed incarnation's device memory is released
    while the exception is held (``run`` drops its state before the
    exception leaves it), and the resumed parameters stay within 1e-5 of a
    run that never failed.  Returns the launch counts of producing the
    drill's 4 batches."""
    import dataclasses

    from repro_torch.core.ctrlplane import SimulatedFailure
    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.data.synth import SyntheticRecSysSource
    from repro_torch.kernels import fused
    from repro_torch.launch import train as driver
    from repro_torch.models import recsys as RS
    from repro_torch.train import CheckpointManager, ElasticTrainer, init_state

    full = train_config()
    cfg = dataclasses.replace(full, data=dataclasses.replace(full.data,
                                                             embedding_rows=ELASTIC_ROWS))
    src = SyntheticRecSysSource(cfg.data, rows=MAIN_ROWS)
    engine = TorchPreStoEngine(TransformSpec.from_source(src))
    store = PartitionedStore(ELASTIC_STEPS, num_devices=4, source=src)
    fused.reset_launches()
    batches = [engine.produce_batch(store, pid) for pid in range(ELASTIC_STEPS)]
    torch.cuda.synchronize()
    launches = dict(fused.LAUNCHES)
    check_launches("elastic", engine.lowered_plan, {1: launches})
    opt, step = driver.recsys_step(cfg, 1e-3, ELASTIC_STEPS)

    def make_state(device):
        return init_state(RS.init_params(torch.Generator().manual_seed(0), cfg, device), opt)

    ck = CheckpointManager(str(ckpt_dir))
    trainer = ElasticTrainer(make_device=lambda: dev, make_state=make_state,
                             make_step=lambda device: step, ckpt=ck, checkpoint_every=2)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        trainer.run(enumerate(batches), max_steps=ELASTIC_STEPS, fail_at=3)
        raise SmokeFailure("elastic: the injected failure did not fire")
    except SimulatedFailure as exc:
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()  # the exception and its traceback alive
        failed = str(exc)
    ck.wait()
    latest = ck.latest_step()
    check(latest == 2, f"elastic: latest step {latest} after the failure, want 2")
    check(after - before <= 64 << 20, f"elastic: {after - before} bytes still allocated "
          f"after the failure (before {before}, after {after})")
    state, metrics = trainer.run(enumerate(batches), max_steps=ELASTIC_STEPS)
    torch.cuda.synchronize()
    drill_s = time.perf_counter() - t0
    check(int(state["step"]) == ELASTIC_STEPS and ck.latest_step() == ELASTIC_STEPS,
          f"elastic: ended at step {int(state['step'])}, latest {ck.latest_step()}")
    straight = make_state(dev)
    for mb in batches:
        straight, _ = step(straight, mb)
    with torch.no_grad():
        worst = max(float((a - b).abs().max()) for a, b in
                    zip(state["params"].parameters(), straight["params"].parameters()))
    n = sum(p.numel() for p in state["params"].parameters())
    print(f"elastic: {cfg.name} feature geometry, tables {cfg.n_tables} x {ELASTIC_ROWS} x "
          f"{cfg.emb_dim} ({n} parameters, checkpoints of {state_bytes(cfg)} bytes), "
          f"checkpoint_every 2: {failed!r}; latest step {latest}; device memory "
          f"{before} bytes before the first incarnation, {after} after the failure "
          f"(exception held); the second incarnation restored step 2 and ended at step "
          f"{int(state['step'])} (loss {float(metrics['loss']):.4f}); largest |resumed - "
          f"straight| {worst:.3g} (bound 1e-5); {drill_s:.2f} s; card {card_line()}")
    check(worst < 1e-5, f"elastic: resumed parameters {worst} from the straight run")
    del state, straight, metrics, batches, trainer
    torch.cuda.empty_cache()
    return {1: launches}


def phase_examples() -> dict:
    """The three examples on the card as a user runs them: the quickstart,
    ``train_recsys_e2e --steps 40`` (its loss must fall) and the kernel
    level of ``presto_vs_disagg`` (RM5, 1,024 rows, fused against unfused).
    Returns each example's launch counts."""
    from repro_torch.examples import presto_vs_disagg, quickstart, train_recsys_e2e
    from repro_torch.kernels import fused

    by_path = {}
    fused.reset_launches()
    losses = quickstart.main([])
    by_path["quickstart"] = {1: dict(fused.LAUNCHES)}
    check(len(losses) == 5 and all(np.isfinite(losses)), f"quickstart losses {losses}")
    fused.reset_launches()
    e2e = train_recsys_e2e.main(["--steps", str(E2E_STEPS)])
    by_path["train_recsys_e2e"] = {1: dict(fused.LAUNCHES)}
    k = max(len(e2e["losses"]) // 10, 1)
    check(e2e["steps"] == E2E_STEPS
          and np.mean(e2e["losses"][-k:]) < np.mean(e2e["losses"][:k]),
          f"train_recsys_e2e: {e2e['steps']} steps, losses {e2e['losses']}")
    fused.reset_launches()
    pvd = presto_vs_disagg.main([])
    by_path["presto_vs_disagg"] = {1: dict(fused.LAUNCHES)}
    card = card_line()
    print(f"examples: quickstart losses {[round(x, 4) for x in losses]}, launches "
          f"{by_path['quickstart'][1]}; train_recsys_e2e {e2e['params']} parameters, "
          f"{e2e['steps']} steps, loss first {np.mean(e2e['losses'][:k]):.4f} -> last "
          f"{np.mean(e2e['losses'][-k:]):.4f} (mean of {k}), checkpoint step "
          f"{e2e['checkpoint_step']}, launches {by_path['train_recsys_e2e'][1]}; card {card}")
    print(f"examples: presto_vs_disagg kernel level, rm5 at 1,024 rows: fused "
          f"{pvd['fused_ms']:.4f} ms/partition, unfused {pvd['unfused_ms']:.4f} ms/partition "
          f"(CUDA events, best of 10), launches {by_path['presto_vs_disagg'][1]}; card {card}")
    return by_path


def phase_sim() -> None:
    """One seeded ``SimHarness`` schedule (1,000 Zipf sessions, 8 workers
    over 4 devices, two kills and a join) replayed twice: the two event
    traces are equal byte for byte."""
    import hashlib

    from repro_torch.core.simclock import SimHarness

    traces, t0 = [], time.perf_counter()
    for _ in range(2):
        h = SimHarness(seed=SIM_SEED, num_workers=8, num_devices=4, straggler_timeout=0.05)
        h.workload(1000, arrival_window_s=4.0)
        h.kill_at(0.5, 1)
        h.kill_at(1.5, 6)
        h.join_at(2.0)
        rep = h.run()
        traces.append(h.trace_bytes())
    check(traces[0] == traces[1] and len(traces[0]) > 1000, "sim: the replay's trace differs")
    print(f"sim: seed {SIM_SEED}, 1000 sessions replayed twice, {rep.events_processed} events "
          f"each, traces equal ({len(traces[0])} bytes, sha256 "
          f"{hashlib.sha256(traces[0]).hexdigest()[:16]}), makespan {rep.makespan_s:.4f} s "
          f"modeled, {rep.starved_count} starved; {time.perf_counter() - t0:.2f} s of host time")


def phase_breakdown(engines: dict, store) -> None:
    """The paper's per-stage latency breakdown (Fig. 5/12) at rm2 on the
    card: ``time_stages`` of the unfused plan (best of 5, synchronised
    around each stage), the Transform kinds' share, and the three plans'
    totals."""
    from repro_torch.core.opgraph import group_times_by_placement, time_stages

    unfused = engines["unfused"]
    pages = unfused.put_pages(unfused.pin_pages(unfused.stage_partition(store, 0)))
    totals = {}
    for name in ("unfused", "presto", "hybrid"):
        plan = engines[name].lowered_plan
        times = time_stages(plan, pages, iters=5, warmup=2)
        totals[name] = sum(times.values())
        if name == "unfused":
            total = totals[name]
            for st in plan.stages:
                print(f"breakdown unfused rm2: {st.name:15s} {st.kind:18s} "
                      f"{times[st.name] * 1e3:8.4f} ms  {times[st.name] / total:6.1%}")
            kinds = sum(times[st.name] for st in plan.stages if st.kind in TRANSFORM_KINDS)
            print(f"breakdown unfused rm2: Transform kinds {TRANSFORM_KINDS} "
                  f"{kinds * 1e3:.4f} ms = {kinds / total:.1%} of {total * 1e3:.4f} ms")
        groups = group_times_by_placement(plan, times)
        print(f"breakdown {name} rm2: total {totals[name] * 1e3:.4f} ms over "
              f"{len(plan.stages)} stages; by placement "
              + ", ".join(f"{g} {t * 1e3:.4f} ms" for g, t in sorted(groups.items())))
    print(f"breakdown rm2: unfused/fused = {totals['unfused'] / totals['presto']:.2f}x, "
          f"hybrid/fused = {totals['hybrid'] / totals['presto']:.2f}x (stage wall times, "
          f"best of 5, one partition)")


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median CUDA-event time of `fn`, L2 flushed before each launch."""
    fn()
    marks = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def device_ms(fn, reps: int, flush: torch.Tensor, kernel: str | None = None) -> float | None:
    """Device time from the profiler, L2 flushed before each call of `fn`:
    the mean over the launches of ``<kernel>_kernel`` (the kernel alone,
    without the launch latency that an event pair around a short kernel also
    measures) or, with no kernel named, the mean per call of everything `fn`
    runs on the card (the flush's fill excluded).  The profiler now and
    then returns a session without the kernel's records, so an empty
    session is taken again, up to three times; None where all three were
    empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if kernel is None:
        keep = lambda key: "Fill" not in key and "Memset" not in key  # noqa: E731
    else:
        keep = lambda key: f"{kernel}_kernel" in key  # noqa: E731
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        hits = [(e.count, e.device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and keep(e.key) and e.device_time_total > 0]
        if hits:
            n = sum(c for c, _ in hits) if kernel is not None else reps
            return sum(t for _, t in hits) / n / 1e3
        print(f"device_ms: a profiler session held no {kernel or 'device'} records; "
              f"taking it again")
    return None


def bound(nbytes: int, ops: int):
    """The least time the card could take: bytes over the memory rate or
    operations over the fp32 rate, whichever is larger."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def fmt_ms(v) -> str:
    return "n/a" if v is None else f"{v:.5f} ms"


def rm5_gen_inputs(dev):
    """One full-width rm5 partition's generated-feature inputs (42
    features, 4096 boundaries): the words, the padded boundaries and the
    hash params, as the presto plan would take them."""
    from repro_torch.core.opgraph import prepare_env
    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.data.synth import make_rm_source
    from repro_torch.kernels import ops

    src = make_rm_source("rm5", rows=MAIN_ROWS, seed=0)
    spec = TransformSpec.from_source(src)
    engine = TorchPreStoEngine(spec)
    pages = engine.put_pages(engine.pin_pages(engine.stage_partition(
        PartitionedStore(1, num_devices=1, source=src), 0)))
    gen_w = prepare_env(pages, engine.lowered_plan.gen_index)["gen_words"]
    return (gen_w, ops.pad_boundaries(spec.bucket_boundaries, dev),
            ops.hash_params(spec.gen_seeds, spec.gen_max, dev))


def phase_timings(engines: dict, store, dev, errs: dict, by_path: dict):
    """Kernel times at the paths' rm2 inputs (and, for the latency-bound
    rows, at the megabatch-2 and rm5 shapes), the presto path's split, and
    each path's device time by kernel."""
    from repro_torch.core.opgraph import prepare_env
    from repro_torch.core.preprocess import flatten_megabatch
    from repro_torch.kernels import bucketize, decode, fused, lognorm, ops, ref, sigridhash

    engine = engines["presto"]
    spec, cfg = engine.spec, engine.spec.cfg
    pages = engine.put_pages(engine.pin_pages(engine.stage_partition(store, 0)))
    env = prepare_env(pages, engine.lowered_plan.gen_index)
    dense_w, sparse_w, gen_w = env["dense_words"], env["sparse_words"], env["gen_words"]
    len_w = env["length_words"]
    sp = ops.hash_params(spec.sparse_seeds, spec.sparse_max, dev)
    gp = ops.hash_params(spec.gen_seeds, spec.gen_max, dev)
    bounds = ops.pad_boundaries(spec.bucket_boundaries, dev)
    width = cfg.id_width
    decoded_dense = ref.bytesplit_decode_grouped(dense_w)
    decoded_gen = ref.bytesplit_decode_grouped(gen_w).reshape(gen_w.shape[0], -1)
    # the unfused plan's intermediates: decoded dense (504, 8192), raw
    # sparse ids (42, 262144), the gen family's bucket counts (21, 8192)
    x_dense = decoded_dense.reshape(dense_w.shape[0], -1)
    sparse_raw = ref.bitunpack_grouped(sparse_w, width).reshape(sparse_w.shape[0], -1)
    gen_counts = ref.bucketize(decoded_gen, bounds)
    # the gen family at megabatch 2 (pids 4 and 5) and at rm5
    pages2 = flatten_megabatch(engine.put_pages(engine.pin_pages(
        engine.stage_megabatch(store, [4, 5]))))
    gen_w2 = prepare_env(pages2, engine.lowered_plan.gen_index)["gen_words"]
    decoded_gen2 = ref.bytesplit_decode_grouped(gen_w2).reshape(gen_w2.shape[0], -1)
    del pages2
    gen_w5, bounds5, gp5 = rm5_gen_inputs(dev)
    decoded_gen5 = ref.bytesplit_decode_grouped(gen_w5).reshape(gen_w5.shape[0], -1)
    wide_rng = np.random.default_rng(3)
    wide_bounds = {m: sorted_bounds(wide_rng, gen_w.shape[0], m, dev) for m in (32769, 65536)}
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB > L2

    def nvals(t, per_group):
        return t.shape[0] * t.shape[1] * per_group

    def lib_bytesplit():
        f, g, _ = dense_w.shape
        return (dense_w.view(torch.uint8).reshape(f, g, 4, 4).transpose(-1, -2)
                .contiguous().view(torch.float32).reshape(f, g, 4))

    def steps(b):
        return int(np.ceil(np.log2(b.shape[1] + 1)))

    searchsorted = "torch.searchsorted(bounds, x, right=True) on decoded floats"

    def gen_row(w, b, p, x):
        return dict(
            run=lambda: fused.fused_gen(w, b, p), plain=lambda: ref.fused_gen(w, b, p),
            yard=lambda: torch.searchsorted(b, x, right=True), yard_name=searchsorted,
            nbytes=w.numel() * 4 * 2 + b.numel() * 4 + p.numel() * 4,
            ops=nvals(w, 4) * (16 + 3 * steps(b)), first=w)

    def bucketize_row(x, b):
        return dict(
            run=lambda: bucketize.bucketize(x, b), plain=lambda: ref.bucketize(x, b),
            yard=lambda: torch.searchsorted(b, x, right=True), yard_name=searchsorted,
            nbytes=x.numel() * 4 * 2 + b.numel() * 4, ops=x.numel() * (2 + 3 * steps(b)),
            first=x)

    rows_spec = {
        "fused_dense": dict(
            run=lambda: fused.fused_dense(dense_w), plain=lambda: ref.fused_dense(dense_w),
            yard=lambda: torch.log1p(torch.clamp_min(decoded_dense, 0)),
            yard_name="torch.log1p(torch.clamp_min(x, 0)) on decoded floats",
            nbytes=dense_w.numel() * 4 * 2, ops=nvals(dense_w, 4) * 24, first=dense_w),
        "fused_sparse": dict(
            run=lambda: fused.fused_sparse(sparse_w, sp, width=width),
            plain=lambda: ref.fused_sparse(sparse_w, sp, width=width),
            yard=None, yard_name="none (no library call decodes bitpack)",
            nbytes=sparse_w.numel() * 4 + sp.numel() * 4 + nvals(sparse_w, 32) * 4,
            ops=nvals(sparse_w, 32) * 16, first=sparse_w),
        "fused_gen": gen_row(gen_w, bounds, gp, decoded_gen),
        "bitunpack": dict(
            run=lambda: decode.bitunpack(sparse_w, width=width),
            plain=lambda: ref.bitunpack_grouped(sparse_w, width),
            yard=None, yard_name="none (no library call decodes bitpack)",
            nbytes=sparse_w.numel() * 4 + nvals(sparse_w, 32) * 4,
            ops=nvals(sparse_w, 32) * 4, first=sparse_w),
        "bitunpack.lengths": dict(
            run=lambda: decode.bitunpack_lengths(len_w, width=cfg.len_width),
            plain=lambda: ref.bitunpack_grouped(len_w, cfg.len_width),
            yard=None, yard_name="none (no library call decodes bitpack)",
            nbytes=len_w.numel() * 4 + nvals(len_w, 32) * 4,
            ops=nvals(len_w, 32) * 4, first=len_w),
        "bytesplit": dict(
            run=lambda: decode.bytesplit(dense_w),
            plain=lambda: ref.bytesplit_decode_grouped(dense_w), bits=True,
            library=lib_bytesplit,
            nbytes=dense_w.numel() * 4 * 2, ops=nvals(dense_w, 4) * 3, first=dense_w),
        "sigridhash": dict(
            run=lambda: sigridhash.sigridhash(sparse_raw, sp),
            plain=lambda: ref.sigridhash_params(sparse_raw, sp),
            yard=None, yard_name="none (no library call hashes)",
            nbytes=sparse_raw.numel() * 4 * 2 + sp.numel() * 4,
            ops=sparse_raw.numel() * 12, first=sparse_raw),
        "bucketize": bucketize_row(decoded_gen, bounds),
        "lognorm": dict(
            run=lambda: lognorm.lognorm(x_dense), plain=lambda: ref.lognorm(x_dense),
            library=lambda: torch.log1p(torch.clamp_min(x_dense, 0)),
            nbytes=x_dense.numel() * 4 * 2, ops=x_dense.numel() * 20, first=x_dense),
    }
    # more shapes of the latency-bound rows: (kernel, row, its launches as
    # measured on the paths, spec).  The megabatch-2 rows take the counts of
    # the paths' megabatch-2 runs; 5b and 6b share their kernel with another
    # stage at another shape, and the counters do not split by stage
    more_spec = (
        ("fused_gen", "3 K=2", 2, gen_row(gen_w2, bounds, gp, decoded_gen2)),
        ("fused_gen", "3b rm5", "not on the paths", gen_row(gen_w5, bounds5, gp5, decoded_gen5)),
        ("bytesplit", "5b", "not split from decode_dense's", dict(
            run=lambda: decode.bytesplit(gen_w), plain=lambda: ref.bytesplit_decode_grouped(gen_w),
            bits=True, nbytes=gen_w.numel() * 4 * 2, ops=nvals(gen_w, 4) * 3, first=gen_w)),
        ("sigridhash", "6b", "not split from hash_sparse's", dict(
            run=lambda: sigridhash.sigridhash(gen_counts, gp),
            plain=lambda: ref.sigridhash_params(gen_counts, gp),
            nbytes=gen_counts.numel() * 4 * 2 + gp.numel() * 4, ops=gen_counts.numel() * 12,
            first=gen_counts)),
        ("bucketize", "7 K=2", 2, bucketize_row(decoded_gen2, bounds)),
        ("bucketize", "7b rm5", "not on the paths", bucketize_row(decoded_gen5, bounds5)),
    ) + tuple(
        # the device-memory search (C8) at rm2's gen shapes, m unpadded
        (name, f"{row} m={m}", "not on the paths", make(m))
        for m in (32769, 65536)
        for name, row, make in (
            ("fused_gen", "3c", lambda m: gen_row(gen_w, wide_bounds[m], gp, decoded_gen)),
            ("bucketize", "7c", lambda m: bucketize_row(decoded_gen, wide_bounds[m])),
        )
    )

    def at_k(name, k):
        return {path: by_k[k][name] for path, by_k in by_path.items() if k in by_k}

    def measure(name, r):
        got = r["run"]()
        (hold_bits if r.get("bits") else hold)(name, got, r["plain"](), errs)
        library = r.get("library")
        if library is not None:  # the same function: it must agree
            (hold_bits if r.get("bits") else hold)(f"{name} library", library(), got, {})
        first = r["first"]
        bound_ms, bound_by = bound(r["nbytes"], r["ops"])
        return {
            "shape": list(first.shape), "bytes": r["nbytes"],
            "ms": time_ms(r["run"], 50, flush),
            "device_ms": device_ms(r["run"], 20, flush, kernel=name.split(".")[0]),
            "floor_device_ms": device_ms(lambda: first.clone(), 20, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(library, 20, flush) if library is not None else None,
            "yardstick": r.get("yard_name"),
            "yardstick_ms": time_ms(r["yard"], 20, flush) if r.get("yard") else None,
            "yardstick_device_ms": device_ms(r["yard"], 20, flush) if r.get("yard") else None,
        }

    out = []
    for name, r in rows_spec.items():
        row = measure(name, r)
        plain_ms = time_ms(r["plain"], 5, flush)
        launches = {path: path_totals(by_k)[name] for path, by_k in by_path.items()}
        print(f"kernel {name} rm2 {tuple(row['shape'])}: {row['ms']:.5f} ms (device "
              f"{fmt_ms(row['device_ms'])}, floor {fmt_ms(row['floor_device_ms'])}), "
              f"{row['bytes']} bytes, bound {row['bound_ms']:.6f} ms ({row['bound_by']}), "
              f"plain {plain_ms:.4f} ms, library {fmt_ms(row['library_ms'])}, yardstick "
              f"{fmt_ms(row['yardstick_ms'])} (device {fmt_ms(row['yardstick_device_ms'])}) "
              f"[{r.get('yard_name', 'none')}], "
              f"launches {launches} (at megabatch 1 {at_k(name, 1)})")
        # the row's shape is megabatch 1's; launches counts every megabatch
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(launches.values()),
            "launches_by_path": launches, "launches_at_megabatch_1": at_k(name, 1),
            "launches_at_megabatch_2": at_k(name, 2), "max_abs_err": errs[name],
            "plain_ms": plain_ms, **row, "more_shapes": [],
        })
    by_name = {row["name"]: row for row in out}
    for name, label, k, r in more_spec:
        row = measure(name, r)
        launches = at_k(name, k) if k == 2 else k
        print(f"kernel {name} row {label} {tuple(row['shape'])}: {row['ms']:.5f} ms (device "
              f"{fmt_ms(row['device_ms'])}, floor {fmt_ms(row['floor_device_ms'])}), "
              f"{row['bytes']} bytes, bound {row['bound_ms']:.6f} ms ({row['bound_by']}), "
              f"yardstick device {fmt_ms(row['yardstick_device_ms'])}, launches {launches}")
        by_name[name]["more_shapes"].append({"row": label, "launches_by_path": launches, **row})

    # main path split per partition (megabatch 1): host staging, copy in,
    # device compute
    split = []
    for pid in (1, 2):
        t0 = time.perf_counter()
        pinned = engine.pin_pages(engine.stage_megabatch(store, [pid]))
        stage_s = time.perf_counter() - t0
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        dev_pages = engine.put_pages(pinned)
        e[1].record()
        engine.preprocess_megabatch(dev_pages)
        e[2].record()
        torch.cuda.synchronize()
        split.append((stage_s, e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])))
    st, h2d, comp = (statistics.mean(x) for x in zip(*split))
    nbytes = sum(v.numel() * 4 for v in pinned.values())
    print(f"main path split per rm2 partition (mean of 2): host staging {st:.3f} s "
          f"(synthetic generation + page build + pin), H2D {h2d:.3f} ms for {nbytes} bytes, "
          f"device compute {comp:.3f} ms")
    t0 = time.perf_counter()
    serial = list(engine.produce_stream(store, range(4), overlap=False))
    print(f"main path: {len(serial) * store.source.rows / (time.perf_counter() - t0):.1f} "
          f"samples/s at megabatch 1 with overlap off (serial), wall clock")
    for name, e in engines.items():
        profile_transform(name, e, dev_pages)
    return out


def profile_transform(path: str, engine, dev_pages) -> None:
    """Device time of one partition's Transform by kernel, from the profiler:
    the port's kernels against the PyTorch glue.  Only rows that are device
    activity are summed (the op that launched a kernel reports its time too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.preprocess_megabatch(dev_pages)
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns an empty session
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.preprocess_megabatch(dev_pages)
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
        if rows:
            break
        print(f"profile {path}: a profiler session held no device records; taking it again")
    else:
        print(f"profile {path}: the profiler saw no device time (not measured)")
        return
    total_us = sum(t for _, _, t in rows)
    ours = [(k, c, t) for k, c, t in rows if any(f"{n}_kernel" in k for n in SOURCES)]
    ours_us = sum(t for _, _, t in ours)
    print(f"profile {path}: one rm2 partition's Transform is {sum(c for _, c, _ in rows)} "
          f"device activities, {total_us:.1f} us busy; the port's kernels "
          f"({sum(c for _, c, _ in ours)} launches) {ours_us:.1f} us, PyTorch glue "
          f"{total_us - ours_us:.1f} us")
    for key, count, t in sorted(rows, key=lambda r: -r[2])[:10]:
        print(f"profile {path}:   {t:9.1f} us  x{count}  {key[:90]}")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    rng = np.random.default_rng(0)
    errs: dict = {}
    phase_build()
    phase_kernels(rng, dev, errs)
    torch.cuda.synchronize()
    phase_standalone_kernels(rng, dev, errs)
    torch.cuda.synchronize()
    engine, store, launches, fused_batches = phase_main_path(dev)
    torch.cuda.synchronize()
    engines, by_path = phase_host_paths(engine.spec, store, fused_batches)
    train_batches = [fused_batches[pid] for pid in range(8)]
    dedup_engines, dedup_by_path, dedup_pages = phase_dedup(dev)
    torch.cuda.synchronize()
    # the store's files live until the trainer has read them through the service
    files_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    try:
        root = Path(files_dir.name)
        store_by_path = phase_store(dev, engine, fused_batches, root)
        torch.cuda.synchronize()
        service_by_path = phase_service(engine, root / "classic", fused_batches, root)
        torch.cuda.synchronize()
        del fused_batches
        phase_train_parity(dev)
        train_by_path = phase_train(dev, train_batches, engine, store, root / "classic")
    finally:
        files_dir.cleanup()
    del train_batches
    # the checkpoints live under build/ (ignored by git) and go once read
    ckpt_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        driver_by_path = phase_driver(engine, ckpt_root / "driver")
        phase_restore(dev, ckpt_root / "driver")
        shutil.rmtree(ckpt_root / "driver")
        elastic_launches = phase_elastic(dev, ckpt_root / "elastic")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    example_by_path = phase_examples()
    phase_sim()
    by_path = {"presto": launches, **by_path,
               **{f"dedup {name}": by_k for name, by_k in dedup_by_path.items()},
               **store_by_path, **service_by_path, **train_by_path,
               **driver_by_path, "elastic": elastic_launches, **example_by_path}
    totals = {n: sum(path_totals(by_k)[n] for by_k in by_path.values()) for n in launches[1]}
    for name, n in totals.items():
        check(n > 0, f"{name} was never launched")
    print(f"launches: all {len(totals)} kernels launched on the paths ({totals})")
    engines["presto"] = engine
    phase_breakdown(engines, store)
    torch.cuda.synchronize()
    kernels = phase_timings(engines, store, dev, errs, by_path)
    for name, e in dedup_engines.items():
        profile_transform(f"dedup {name}", e, dedup_pages)
    torch.cuda.synchronize()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
