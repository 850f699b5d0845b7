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
* the DLRM's embedding bag (``phase_embedding``): the hand-written
  forward and backward against the plain version at rm2's shapes (the
  main path's first batch) and rm1's, the tables at full size, the
  gradient held to a float64 bound and bit-identical over two backward
  calls, one launch of each pass; then their kernel-table rows;
* training: three reduced-width DLRM steps on the card against the CPU
  from the same weights, then the full RM2 DLRM (63 tables of 500,000 x 128
  floats, ~61 GiB with AdamW, freed after) for 8 train steps on the presto
  path's 8 batches and 3 ingest steps (pages in, the fused kernels inside
  the step) on one partition, whose loss must fall, and 4 more steps from
  the same state through ``TrainingPipeline.run_session``, fed by a
  service session (2 workers) over the store's 4 classic partition files;
  every train step launches the embedding bag's forward and backward
  once each;
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
* the meshed elastic drill (``phase_mesh_elastic``): ``ElasticTrainer``
  over a (1, 2) world of ranks sharing the card (rm2's features and MLPs,
  5,000-row tables), checkpoints of the sharded state every 2 steps in the
  global format, a failure at step 3 whose ranks exit and return their
  device memory, the meshed save byte for byte a one-device save of the
  same state, resumes on (1, 2) (within 1e-5 of a straight run there) and
  on one device: in f64 within 1e-5 of a straight one-device run; in f32,
  where the mesh's order of sums flips a first-step ReLU (measured), to
  the train rule beside a straight mesh run's own distance;
* the meshed paths (``phase_mesh``, after the service): ranks that share
  the card, spawned by ``launch.mesh.run_spmd`` and joined by gloo with
  every hop staged through pinned host memory (NCCL refuses two ranks on
  one device; the script prints the world, the rank -> device map and the
  transport): (a) ``preprocess_global`` on a (4, 2) (data, model) mesh of
  8 ranks over 4 classic and 2 dedup-4 files of ``phase_store`` under
  presto, hybrid, disagg and unfused, every gathered global batch bitwise
  the one-device batch, each rank's bytes the hopped families' bytes,
  presto with no collective call (paths "mesh presto", "mesh hybrid",
  "mesh disagg", "mesh unfused", each summed over the ranks); (b) the
  row-sharded bag over RM2's full tables on model = 4 against the
  one-device plain bag and its table gradient; (c) three meshed train steps with
  the full tables split over 2 ranks against three one-device steps from
  the same params; (d) the int8-compressed step across 2 pods at 25,000
  table rows against the uncompressed meshed step; (e)
  ``repro_torch.examples.presto_vs_disagg`` as a user runs it: its kernel
  level (rm5, 1,024 rows, fused against unfused) and its system level on
  16 ranks;
* the examples (``phase_examples``): ``repro_torch.examples.quickstart``
  and ``train_recsys_e2e --steps 40`` (its loss must fall);
* the simulator (``phase_sim``): one seeded ``SimHarness`` schedule of
  1,000 sessions with kills and a join, replayed twice, the traces equal;
* the dense LM serving path (``phase_lm_serve``): reduced h2o-danube,
  gemma-7b and gemma3-12b in f32 on the card against the port's CPU run
  (1e-4, greedy tokens equal); the full h2o-danube-1.8b in bf16, batch 4,
  a prompt of 8,192 tokens and 32 generated (prefill s, decode ms a step,
  tok/s, peak bytes, the decode step's byte floor), the first and last
  decode steps held against a prefill's logits at their positions; and
  ``repro_torch.launch.serve`` with its defaults; none of the eight
  kernels launched;
* the rest of LM serving (``phase_lm_families``): the reduced mamba2,
  jamba, grok-1, llama4 and seamless in f32 on the card against the port's
  CPU run (1e-4, greedy tokens equal); the full mamba2-1.3b and one period
  of jamba-v0.1-52b (8 of 32 layers, bf16 params) in bf16 at batch 4, a
  prompt of 8,192 and 32 generated (prefill s, decode ms a step, tok/s,
  peak bytes, a decode step's launches, busy ms and idle share, its byte
  floor), each decode held against a prefill's logits at the first and last
  generated positions, the MoE's dropped choices counted; the full
  seamless-m4t-medium in f32 against the CPU, then 4 x 4,096 frames encoded
  and 32 tokens decoded in bf16; ``repro_torch.examples.serve_lm`` with its
  defaults; none of the eight kernels launched;
* LM training (``phase_lm_train``): every arch's reduced config in f32 on
  the card against the port's CPU run (loss, every gradient leaf, one
  update of the full config's optimizer; 1e-4); at full width in bf16 on
  one ``TokenSynthesizer`` batch: h2o-danube-1.8b (4 x 4,096 in 2
  microbatches, "dots" remat, 3 AdamW then 1 Adafactor step; the first
  step's xent held against the serving forward's), mamba2-1.3b (4 x 4,096,
  AdamW; every gradient finite at chunk 128), seamless-m4t-medium (4 x
  4,096 frames and tokens, AdamW) and one period of jamba-v0.1-52b (bf16
  params, Adafactor; the MoE aux non-zero), each loss falling and each
  held-out xent at the stream's entropy, every Adafactor update of h2o
  and jamba's first held against a plain one-pass Adafactor, with step
  ms, tok/s, the optimizer's ms, peak bytes, a step's launches and idle
  share, its FLOP bounds and its model-FLOP share (``launch.roofline``),
  h2o's ``useful_ratio`` (model FLOPs over ``FlopCounterMode``'s count of
  one forward and backward); ``launch.train --mode lm`` with its defaults;
  none of the eight kernels launched;
* the meshed LM (``phase_lm_mesh``), ranks sharing the card over
  gloo-staged, each witness run in this process and freed before the
  spawn: (n) context-parallel decode of the full h2o-danube-1.8b at
  long_500k's shape (batch 1, 524,288 positions, 16.1 GB of K/V a rank) on
  2 ranks against one device over the whole cache, the writes across the
  slices' border on the owning rank, the collective bytes a step; (o) one
  period of jamba-v0.1-52b under llama4's expert rule on (data=2, model=1),
  dispatching by all-to-all, against the dense dispatch (logits, drops,
  all-to-all bytes); (p) one expert-parallel train step of the reduced
  llama4 in f32 against the CPU's one-device step; none of the eight
  kernels launched;
* the LM's TP/FSDP layout (``phase_lm_tp``): (r) h2o-danube-1.8b trained
  on (data=2, model=2) against the one-device step, (s) served there, (t)
  one jamba-v0.1-52b period on (model=2); (u) the dry run of every
  production cell (its blocks; two cells traced on meta tensors with the
  reference's memory and roofline columns); (v) the dry run's traces of
  (j)'s, a rank of (r)'s and (i)'s train steps held to this run's card:
  the traced peaks within DRY_PEAK_TOL of ``max_memory_allocated``, (r)'s
  collectives and (i)'s FLOPs equal to the counted ones.  The traces run
  on the host in a process of their own, started before ``phase_lm_train``
  (after every phase whose times move with the host);

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

import atexit
import contextlib
import gc
import json
import math
import os
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

from repro_torch.common.util import card_line  # noqa: E402

CARD = torch.device("cuda", 0)  # the one card the script runs on

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
    "embedding_bag": CSRC + "embedding.cu",
    "embedding_bag.backward": CSRC + "embedding.cu",
}
# the JAX package pools with a plain gather and leaves the gradient to XLA
BAG_REPLACES = "none: src/repro/models/recsys.py:97 _local_bag is a gather, no pallas_call"
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
    "embedding_bag": BAG_REPLACES,
    "embedding_bag.backward": BAG_REPLACES,
}
# the DLRM's kernels: launched by a train step, once each a step, never by a
# Transform plan
MODEL_KERNELS = ("embedding_bag", "embedding_bag.backward")
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
BAG_ROWS, BAG_SEED = 8192, 3  # the train cells' batch; the bag phase's draws
TRAIN_LR = (3e-4, 2, 100)  # peak, warmup and total steps of the schedule
TRAIN_RANGES = ("dlrm.embedding_bag", "adamw")  # the port's spans (common.util.span)
# the training driver at full width (launch.train --mode recsys): 4 steps fed
# by 2 service workers over 6 source partitions, rm2 and then CKPT_CONFIG with
# its checkpoint.  A call of the GPU machine may write 45 GiB to its disk, and
# rm2's checkpoint alone is 45.11 GiB; rm1's is 27.93 GiB.
DRIVER_PARTITIONS, DRIVER_STEPS = 6, 4
CKPT_CONFIG = "rm1"
# the elastic drill: RM2's feature geometry with tables cut from 500,000 to
# 25,000 rows (205.9M parameters, 2.47 GB checkpoints, written twice), 4
# steps, a failure at 3; the writes of the whole run stay under the disk's cap
ELASTIC_ROWS, ELASTIC_STEPS = 25_000, 4
# the meshed elastic drill (phase_mesh_elastic): RM2's feature geometry and
# MLPs with tables cut to 5,000 rows (0.536 GB checkpoints in f32, 4 saves;
# 0.714 GB in the f64 control, 2 saves), ranks sharing the card; a failure
# at step 3 on MESH_ELASTIC, resumes on it and on one device
MESH_ELASTIC, MESH_ELASTIC_ROWS = (1, 2), 5_000
# the LM serving path (phase_lm_serve): reduced-width parity on the card
# against the CPU, then the full h2o-danube-1.8b in bf16
LM_PARITY_ARCHS, LM_PARITY_PROMPT, LM_PARITY_DECODE = (
    ("h2o-danube-1.8b", "gemma-7b", "gemma3-12b"), 96, 8)
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "h2o-danube-1.8b", 4, 8192, 32
LM_CHECK_LEN = 9216  # the prefill that holds decode: a multiple of the 1,024-token kv block
# max |decode - prefill| logits in bf16 at full width: the bound of the CPU
# test (tests/test_torch_lm_serve.py), about three bf16 ulps at the logits'
# size; what a planted fault (a step one position late) moves is printed
LM_BF16_TOL = 0.05
LM_SEED = 0
# the rest of LM serving (phase_lm_families): (d) the reduced MoE, SSM,
# hybrid and enc-dec archs in f32 on the card against the CPU; (e) the full
# mamba2-1.3b and (f) one period of jamba-v0.1-52b (8 of 32 layers, every
# layer kind and width; bf16 params: f32 masters and a bf16 copy, ~79.5 GB,
# do not fit the card) in bf16, each at LM_BATCH x LM_PROMPT with LM_GEN
# generated; (g) the full seamless-m4t-medium, LM_BATCH x ENCDEC_FRAMES
# frames encoded and LM_GEN tokens decoded, held in f32 against the CPU at
# ENCDEC_CHECK (frames, steps)
LM_FAMILY_PARITY = ("mamba2-1.3b", "jamba-v0.1-52b", "grok-1-314b",
                    "llama4-maverick-400b-a17b", "seamless-m4t-medium")
LM_FULL = (("mamba2-1.3b", {}), ("jamba-v0.1-52b", {"n_layers": 8, "param_dtype": "bfloat16"}))
# max |decode - prefill| logits in bf16 at full width: twice the largest of
# a bf16 CPU rehearsal at d_model 256 with every other width and the depth
# kept (3 seeds, prompt 2,048: mamba2 0.0620, jamba 0.0234), rounded up to
# a power of two (PERF.md §6); SSD's chunked prefill and its f32 recurrent
# decode round differently
LM_FULL_TOL = {"mamba2-1.3b": 0.125, "jamba-v0.1-52b": 0.0625}
ENCDEC_ARCH, ENCDEC_FRAMES, ENCDEC_CHECK = "seamless-m4t-medium", 4096, (256, 8)
ENCDEC_F32_TOL = 1e-4  # f32 on the card against the CPU, as (a) and (d)
# LM training (phase_lm_train): (h) every arch's reduced config in f32 on the
# card against the CPU (loss, every gradient leaf and one update of the full
# config's optimizer within 1e-4); at full width in bf16 on one TokenSynthesizer
# batch, warmup_cosine(*LM_TRAIN_LR): (i) h2o-danube-1.8b, "dots" remat, 4 x
# 4,096 in 2 microbatches (a step ~11 s, host-bound: ~1.8e5 launches),
# AdamW steps, then Adafactor steps on the weights they left; (j)
# mamba2-1.3b, 4 x 4,096 ("dots"), AdamW; (k) seamless-m4t-medium, 4 x 4,096
# frames and tokens, AdamW; (l) one period of jamba-v0.1-52b (8 of 32 layers,
# bf16 params: with f32 masters the 13.3B parameters and their gradients would
# not fit), Adafactor, batch 1; (m) launch.train --mode lm, its defaults but the steps
# (m)'s steps: the CLI's other defaults (mamba2-1.3b, 8 x 256); 50, its
# default, until phase_lm_tp made room for itself
LM_TRAIN_CLI_STEPS = 10
LM_TRAIN_PARITY_SEQ = 96  # past h2o's window (64), llama4's chunk and 3 SSD chunks
LM_TRAIN_LR = (1e-3, 2, 100)
# a run's steps: a warm-up, the profiled step, then the timed ones
# (3 AdamW and 1 Adafactor steps for (i), 3 for the others: 5, 3 and 5
# until phase_lm_tp made room for itself; (i)'s first 2 AdamW steps are
# phase_lm_tp (r)'s witness)
LM_TRAIN_H2O = (4, 4096, 2, 3, 1)  # batch, seq, microbatches, AdamW steps, Adafactor steps
LM_TRAIN_MAMBA = (4, 4096, 3)  # batch, seq, steps
LM_TRAIN_ENCDEC = (4, 4096, 3)  # batch, frames (= tokens), steps
# seamless at LM_TRAIN_LR's peak of 1e-3 oscillates: 12.98, 14.78, 12.78,
# 14.35, 14.24 on an H100 (PERF.md §6); a tenth of it, beside the
# reference's own peak of 3e-4 (launch.specs.make_optimizer_for)
LM_TRAIN_ENCDEC_LR = (1e-4, 2, 100)
LM_TRAIN_JAMBA = (1, 4096, 3)  # batch, seq, steps
# the held-out xent (the stream's next batch) may sit this far below the
# stream's unigram entropy: the sampling noise of a mean over 8,192 tokens
# is ~0.03 nats; a model that sees its labels goes many nats below
LM_TRAIN_HELDOUT_SLACK = 0.5
# jamba's leaves witnessed against plain_adafactor: all but the expert
# stacks (0.94e9 elements: a plain f32 pass over one takes ~26 GB beside the
# 53 GB of bf16 parameters and gradients), the embedding and the head included
LM_TRAIN_WITNESS_ELEMS = 1 << 28
# |the first train step's xent - the xent of prefill_hidden on the same
# tokens|: the same bf16 forward (remat recomputes, it does not change a
# value); the bound is 1e-3 of a loss near ln(32,000) = 10.4
LM_TRAIN_XENT_TOL = 0.01
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores (data sheet)
# the meshed LM (phase_lm_mesh), ranks sharing the card over gloo-staged:
# (n) context-parallel decode of the full h2o-danube-1.8b at long_500k's
# shape on (data=2): LM_CP_LEN cache positions (16.1 GB of bf16 K/V a rank),
# filled with seeded values but the last LM_MESH_GEN, one draw a LM_CP_BLOCK
# positions of a layer, so each rank fills its own slice; 2 steps across the
# slices' border, then LM_MESH_GEN at the end of the cache
LM_CP_LEN, LM_CP_BLOCK = 524_288, 65_536
# the steps (n) decodes at the end of the cache and (o) generates: 32 until
# phase_lm_tp made room for itself (a decode step there gathers
# every FSDP weight over data through the host, ~5 s)
LM_MESH_GEN = 2
# (o) expert-parallel serving: one period of jamba-v0.1-52b (as (f)) under
# llama4's expert rule on (data=2, model=1), LM_BATCH rows (2 a rank),
# LM_EP_PROMPT (8,192 until phase_lm_tp made room for itself) and
# LM_MESH_GEN generated, held within (f)'s LM_FULL_TOL
LM_EP_RULE = {"experts": "data", "ff": "model"}
LM_EP_OVERRIDES = {"n_layers": 8, "param_dtype": "bfloat16"}
LM_EP_PROMPT = 4096
# (p) expert-parallel training: one meshed step of the reduced llama4 in
# f32, batch x seq, against the CPU's one-device step over 2 microbatches
# (the ranks' rows: the same function) within rtol=atol=LM_EP_TRAIN_TOL
LM_EP_TRAIN, LM_EP_TRAIN_TOL = (4, 128), 1e-5
# the LM's tensor-parallel and FSDP layout (phase_lm_tp), the reference's
# GSPMD layout run by ranks sharing the card over gloo-staged, each witness
# run in this process first and freed before the spawn: (r) h2o-danube-1.8b
# training at full width on LM_TP_MESH (data, model), bf16 compute,
# LM_TP_REMAT, LM_TP_TRAIN (batch, seq, AdamW steps) against the one-device step
# over LM_TP_MESH[0] microbatches (the data ranks' rows: the same
# function): the loss within LM_TP_LOSS_TOL, the gradient norm within
# LM_TP_NORM_TOL of it, every updated parameter block within 2 lr a step (an
# AdamW step moves an element by about lr); (s) h2o serving on LM_TP_MESH:
# prefill of LM_TP_SERVE's batch x prompt under the prefill rules, its decode
# steps under decode_32k's rules (kv_seq -> model), teacher-forced with the
# one-device greedy tokens, the logits within LM_BF16_TOL; (t) one
# jamba-v0.1-52b period (bf16 params) under its default rules on (model=2):
# LM_TP_JAMBA, the logits within LM_FULL_TOL, the drops equal; (u) the dry
# run of every production cell; (v) its traces held to the card (DRY_CELLS)
LM_TP_MESH = (2, 2)
LM_TP_TRAIN = (4, 4096, 2)
# (r)'s remat: "full", not h2o's "dots" that the witness ran (the same
# function, bitwise on the CPU, and the same collectives: both stop the
# recompute before the MLP's sum); "dots" keeps ~5.5 GB more a rank, and
# four ranks at 17 GiB with their contexts ran the 80 GB card out of memory
LM_TP_REMAT = "full"
LM_TP_LOSS_TOL, LM_TP_NORM_TOL = 0.02, 0.01
# (u) the dry run (launch.dryrun): every production cell's blocks a rank, and
# DRY_CELLS (arch, shape, mesh) traced on meta tensors; (v) the trace's peak
# within DRY_PEAK_TOL of the card's max_memory_allocated for (j) and a rank of
# (r), (r)'s collectives and (i)'s FLOPs as counted.  Both trace in a process
# of their own (dry_traces), started before the LM's training, while the card runs
DRY_CELLS = (("h2o-danube-1.8b", "decode_32k", "single"),
             ("llama4-maverick-400b-a17b", "decode_32k", "multi"))
DRY_PEAK_TOL = 0.10
LM_TP_SERVE = (4, 4096, 2)  # a prompt of 8,192 until the script neared its 1,200 s
LM_TP_SAMPLE = 1 << 16  # elements of each parameter block (r) brings back, evenly spaced
LM_TP_JAMBA = (4, 4096, 16)
E2E_STEPS = 40  # train_recsys_e2e's steps on the card
SIM_SEED = 11
# the meshed paths (phase_mesh): ranks sharing the card, spawned per world
MESH_PRE = (4, 2)  # (a) preprocess_global, (data, model)
MESH_PLACEMENTS = {"presto": ("presto", None), "hybrid": ("hybrid", None),
                   "disagg": ("disagg", None), "unfused": ("disagg", "unfused")}
MESH_DEDUP_PIDS = (0, 1)  # of phase_store's dedup-4 files
MESH_EMB = (1, 4)  # (b) the row-sharded bag over RM2's full tables
MESH_TRAIN, MESH_TRAIN_STEPS = (1, 2), 3  # (c) the meshed train step, full tables
MESH_PODS, MESH_PODS_ROWS = (2, 1, 1), ELASTIC_ROWS  # (d) compressed, (pod, data, model)
MESH_EXAMPLE = (8, 2)  # (e) presto_vs_disagg's default system-level mesh
MESH_SEED = 5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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
    other Transform kernel was (the model's are counted by
    ``check_bag_launches``)."""
    want = {STAGE_KERNELS[st.kind] for st in plan.stages if st.kind in STAGE_KERNELS}
    for name, n in path_totals(by_k).items():
        if name in MODEL_KERNELS:
            continue
        if name in want:
            check(n > 0, f"{path}: {name} was never launched")
        else:
            check(n == 0, f"{path}: {name} launched {n} times, but is not in the plan")


def check_bag_launches(path: str, launches: dict, steps: int) -> None:
    """One embedding bag forward and one backward launch a train step."""
    got = {name: launches[name] for name in MODEL_KERNELS}
    check(got == dict.fromkeys(MODEL_KERNELS, steps),
          f"{path}: {steps} train steps launched the embedding bag {got}")


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


# ---------------------------------------------------------------------------
# The meshed paths (phase_mesh): ranks that share the one card, spawned by
# launch.mesh.run_spmd.  The rank programs below are module-level so that a
# spawned rank (which imports this file as __mp_main__, main() not run)
# finds them.


def seeded_table(cfg, t: int, device) -> torch.Tensor:
    """Table t of a DLRM drawn from its own generator (MESH_SEED, t), so
    that a rank draws its rows table by table without the whole tables."""
    g = torch.Generator(device=device)
    g.manual_seed(MESH_SEED * 1_000_003 + t)
    return torch.empty((cfg.data.embedding_rows, cfg.emb_dim), device=device).normal_(
        generator=g).mul_(0.01)


def seeded_dlrm(cfg, device, rules=None):
    """A DLRM from MESH_SEED: the tables from ``seeded_table``, the MLPs
    from ``init_from_schema``.  With meshed `rules`, this rank's blocks."""
    from repro_torch.distributed.sharding import shard
    from repro_torch.models import recsys as RS
    from repro_torch.models.layers import init_from_schema

    schema = RS.model_schema(cfg)
    schema.pop("tables")
    params = init_from_schema(torch.Generator().manual_seed(MESH_SEED), schema, torch.float32,
                              device)
    specs = RS.param_pspecs(cfg, rules) if rules is not None else None
    if specs is not None:
        params = {g: {k: shard(v, rules.mesh, specs[g][k]).contiguous() for k, v in d.items()}
                  for g, d in params.items()}
    rows = cfg.data.embedding_rows
    lo, hi = 0, rows
    if specs is not None:
        probe = shard(torch.arange(rows), rules.mesh, specs["tables"][1:2])
        lo, hi = int(probe[0]), int(probe[-1]) + 1
    tables = torch.empty((cfg.n_tables, hi - lo, cfg.emb_dim), device=device)
    for t in range(cfg.n_tables):
        tables[t] = seeded_table(cfg, t, device)[lo:hi]
    params["tables"] = tables
    return RS.DLRM(cfg, params)


def family_hop_bytes(spec, rows: int, fams, n_data: int) -> int:
    """Bytes one rank moves per global batch of `rows` when `fams` run on
    the host: each hopped family's pages and batch keys over the data
    axis, gen's pages regathered (not hopped) when dense hops too."""
    from repro_torch.core import opgraph

    page_b = opgraph.family_page_bytes(spec, rows)
    out_b = opgraph.family_batch_bytes(spec, rows)
    skip_gen = "gen" in fams and "dense" in fams
    return sum(((0 if f == "gen" and skip_gen else page_b[f]) + out_b[f]) // n_data
               for f in fams)


def table_sq(grad: torch.Tensor) -> float:
    """Sum of squares of a (T, R, D) gradient in f64, one table at a time."""
    return sum(float(g.double().square().sum()) for g in grad)


def mesh_bits(t: torch.Tensor) -> torch.Tensor:
    """Bits of a batch tensor (floats as int32), for bitwise comparisons."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def mesh_preprocess_rank(mesh, spec, dspec, root: str, want_dir: str) -> dict:
    """(a): the rank's data block of each partition, staged once (file
    read, dedup inflation, page build, shard, pin; host clock), then
    copied in and preprocessed under each placement, the counters zeroed
    just before each placement and read just after; every gathered global
    batch bitwise the one-device batch."""
    from repro_torch.core.presto import TorchPreStoEngine, gather_minibatch, shard_pages
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.kernels import fused

    dev = mesh.device
    runs = [("classic", pid) for pid in range(4)] + [("dedup", pid) for pid in MESH_DEDUP_PIDS]
    stores = {k: PartitionedStore(4, 4, None, root=f"{root}/{k}") for k in ("classic", "dedup")}
    n_data = mesh.shape["data"]
    out = {"placements": {}, "stage_ms": []}
    engines_of = {name: {k: TorchPreStoEngine(s, mesh, placement=placement,
                                              kernel_mode=kernel_mode)
                         for k, s in (("classic", spec), ("dedup", dspec))}
                  for name, (placement, kernel_mode) in MESH_PLACEMENTS.items()}
    staged = {}
    for kind, pid in runs:  # staging depends on the mesh, not on the placement
        stager = engines_of["presto"][kind]
        t0 = time.perf_counter()
        staged[kind, pid] = stager.pin_pages(
            shard_pages(stager.stage_partition(stores[kind], pid), mesh))
        out["stage_ms"].append((time.perf_counter() - t0) * 1e3)

    def global_batch(engine, pages):
        mb = engine.preprocess_global(engine.put_pages(pages))
        torch.cuda.current_stream(dev).synchronize()
        return mb

    for engines in engines_of.values():  # warm-up: the rank's first loads and hops
        global_batch(engines["classic"], staged["classic", 0])
    for name, engines in engines_of.items():
        fams = engines["classic"].host_families()
        ms, per_run, batches = [], [], []
        fused.reset_launches()
        mesh.counter.reset()
        for kind, pid in runs:
            before = mesh.counter.total_bytes
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            batches.append(global_batch(engines[kind], staged[kind, pid]))
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            per_run.append(mesh.counter.total_bytes - before)
        launches = dict(fused.LAUNCHES)
        calls = mesh.counter.total_calls
        hop_s = sum(mesh.counter.seconds.values())
        want_bytes = family_hop_bytes(spec, batches[0]["labels"].shape[0] * n_data, fams, n_data)
        check(all(n == want_bytes for n in per_run),
              f"mesh {name}: rank {mesh.rank} moved {per_run} bytes per batch, the family "
              f"bytes say {want_bytes}")
        check(name != "presto" or calls == 0, f"mesh presto: {calls} collective calls")
        for (kind, pid), mb in zip(runs, batches):
            whole = gather_minibatch(mb, mesh)
            if mesh.coords["data"] == 0:
                for key, v in whole.items():
                    want = torch.from_numpy(np.load(f"{want_dir}/{kind}-{pid}-{key}.npy"))
                    check(torch.equal(mesh_bits(v).cpu(), mesh_bits(want)),
                          f"mesh {name}: {kind} pid {pid} {key} differs from the one-device batch")
        out["placements"][name] = {"ms": ms, "bytes": want_bytes, "calls": calls,
                                   "hop_ms": hop_s * 1e3 / len(runs), "launches": launches,
                                   "host_families": fams}
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    return out


def mesh_embedding_rank(mesh, cfg, ids_path: str, want_path: str) -> dict:
    """(b): the row-sharded bag of the whole batch over this rank's rows of
    the full tables, and the gradient of sum(pooled * w) for its rows."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import recsys as RS

    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    rules = ShardingRules.make(mesh)
    tables = seeded_dlrm(cfg, dev, rules).tables
    ids = {k: torch.from_numpy(v).to(dev) for k, v in np.load(ids_path).items()}
    w = mesh_weights(cfg, ids["lengths"].shape[0], dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    pooled = RS.sharded_embedding_bag(tables, ids["multi_hot_ids"], ids["lengths"],
                                      ids["one_hot_ids"], mesh, "model")
    (pooled * w).sum().backward()
    b.record()
    b.synchronize()
    want = np.load(want_path)
    r = tables.shape[1]
    lo = mesh.coords["model"] * r
    t_i, row_i = torch.from_numpy(want["t"]).to(dev), torch.from_numpy(want["row"]).to(dev)
    mine = (row_i >= lo) & (row_i < lo + r)
    got_rows = tables.grad[t_i[mine], row_i[mine] - lo]
    grad_err = float((got_rows - torch.from_numpy(want["grad"]).to(dev)[mine]).abs().max())
    pooled_err = None
    if mesh.rank == 0:
        pooled_err = float((pooled.detach() - torch.from_numpy(np.load(want["pooled"].item()))
                            .to(dev)).abs().max())
    return {"ms": a.elapsed_time(b), "pooled_err": pooled_err, "grad_err": grad_err,
            "rows_checked": int(mine.sum()), "sq": table_sq(tables.grad),
            "peak": torch.cuda.max_memory_allocated(dev), "bytes": dict(mesh.counter.bytes),
            "hop_ms": sum(mesh.counter.seconds.values()) * 1e3}


def mesh_weights(cfg, b: int, dev) -> torch.Tensor:
    """The (B, T, D) weights of (b)'s loss sum(pooled * w), from MESH_SEED."""
    g = torch.Generator(device=dev)
    g.manual_seed(MESH_SEED)
    return torch.empty((b, cfg.n_tables, cfg.emb_dim), device=dev).normal_(generator=g)


def mesh_train_rank(mesh, cfg, batch_paths) -> dict:
    """(c): the meshed train step over the rank's blocks of the tables."""
    from repro_torch.distributed.sharding import ShardingRules, shard
    from repro_torch.models import recsys as RS
    from repro_torch.train import make_train_step

    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    rules = ShardingRules.make(mesh)
    opt, state, _ = train_setup(cfg, seeded_dlrm(cfg, dev, rules))
    step = make_train_step(lambda m, b: RS.loss_fn(m, b, cfg, rules), opt, rules=rules,
                           param_specs=RS.flat_param_pspecs(cfg, rules))
    row = rules.pspec("batch")
    losses, ms = [], []
    for path in batch_paths:
        batch = {k: shard(v, mesh, row).to(dev) for k, v in torch.load(path).items()}
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, metrics = step(state, batch)
        b.record()
        b.synchronize()
        losses.append(float(metrics["loss"]))
        ms.append(a.elapsed_time(b))
    return {"losses": losses, "ms": ms, "peak": torch.cuda.max_memory_allocated(dev),
            "tables": tuple(state["params"].tables.shape),
            "hop_ms": sum(mesh.counter.seconds.values()) * 1e3 / len(batch_paths)}


def mesh_pods_rank(mesh, cfg, batch_path: str) -> dict:
    """(d): two int8-compressed steps over (pod, data, model), and from the
    same params and rows one uncompressed meshed step and one averaged
    within the pod only.  The gradients that the first compressed update
    receives are held against the f32 mean over pod and data (the
    uncompressed step's) within the quantization bound, (s_0 + s_1) / 4 for
    the pods' scales s_p.  The error feedback e after it must be the pod's
    residual x - q * s: |e| <= s / 2, and (x - e) / s whole numbers, with
    x the pod's mean gradient from the pod-averaged step (the same
    gradient up to the summation order of the card's kernels)."""
    from repro_torch.distributed import comm
    from repro_torch.distributed.sharding import ShardingRules, shard
    from repro_torch.models import recsys as RS
    from repro_torch.train import (
        Optimizer, adamw, init_state, make_compressed_train_step, make_train_step,
        warmup_cosine)

    dev = mesh.device
    inner = ShardingRules.make(mesh, overrides={"batch": ("data",)})
    outer = ShardingRules.make(mesh)
    specs = RS.flat_param_pspecs(cfg, inner)
    batch = {k: shard(v, mesh, outer.pspec("batch")).to(dev)
             for k, v in torch.load(batch_path).items()}
    opt = adamw(warmup_cosine(*TRAIN_LR))
    seen = {}  # the gradients each first update received (it scales them in place)

    def recording(key):
        def update(grads, state, params, sq_sum=None, **kw):
            if key not in seen:
                seen[key] = {k: g.detach().clone() for k, g in grads.items()}
            return opt.update(grads, state, params, sq_sum, **kw)

        return Optimizer(opt.init, update)

    model = seeded_dlrm(cfg, dev, inner)
    state = init_state(model, opt, with_err=True)
    cstep = make_compressed_train_step(lambda m, b: RS.loss_fn(m, b, cfg, inner),
                                       recording("compressed"), inner, specs)
    mesh.counter.reset()
    state, m1 = cstep(state, batch)
    hop = {"bytes": dict(mesh.counter.bytes), "calls": dict(mesh.counter.calls)}
    after_one = {k: v.detach().clone() for k, v in model.named_parameters()}
    err = state["err"]
    state, m2 = cstep(state, batch)
    del model, state, cstep
    for key, rules in (("global", outer), ("pod", inner)):
        umodel = seeded_dlrm(cfg, dev, inner)
        ustep = make_train_step(lambda m, b, r=rules: RS.loss_fn(m, b, cfg, r),
                                recording(key), rules=rules, param_specs=specs)
        mesh.counter.reset()
        ustep(init_state(umodel, opt), batch)
        if key == "global":
            f32 = {"bytes": dict(mesh.counter.bytes), "calls": dict(mesh.counter.calls)}
            diff = max(float((after_one[k] - v.detach()).abs().max())
                       for k, v in umodel.named_parameters())
        del umodel, ustep
    got, exact, x = seen["compressed"], seen["global"], seen["pod"]
    names = list(x)
    s_own = torch.stack([x[k].abs().max() / 127.0 + 1e-12 for k in names])
    s_all = comm.all_gather(s_own, mesh, "pod")  # (pods, leaves)
    ratio, own_ratio, err_half, err_frac = 0.0, 0.0, 0.0, 0.0
    for i, k in enumerate(names):
        err_half = max(err_half, float(err[k].abs().max() / s_own[i]))
        q = (x[k] - err[k]) / s_own[i]
        err_frac = max(err_frac, float((q - torch.round(q)).abs().max()))
        bound = s_all[:, i].sum() / 4 + 1e-6 * exact[k].abs().max()
        ratio = max(ratio, float((got[k] - exact[k]).abs().max() / bound))
        own_ratio = max(own_ratio, float((x[k] - exact[k]).abs().max() / bound))
    numel = sum(v.numel() for v in after_one.values())
    return {"losses": [float(m1["loss"]), float(m2["loss"])], "max_diff": diff, "hop": hop,
            "f32": f32, "numel": numel, "leaves": len(after_one), "ratio": ratio,
            "own_ratio": own_ratio, "err_half": err_half,
            "err_frac": err_frac}


def mesh_pods(dev, cfg, batch_path: str, card: str) -> None:
    """(d) on MESH_PODS: runs ``mesh_pods_rank`` on every rank and holds
    its results (see ``phase_mesh``)."""
    from repro_torch.launch.mesh import run_spmd

    t0 = time.perf_counter()
    ranks = run_spmd(mesh_pods_rank, MESH_PODS, ("pod", "data", "model"), device=dev,
                     args=(cfg, batch_path))
    for r in ranks:
        check(r["losses"][1] < r["losses"][0], f"mesh (d): losses {r['losses']} do not fall")
        check(r["ratio"] <= 1.0, f"mesh (d): the compressed update's gradients {r['ratio']} "
                                 f"times the quantization bound from the f32 mean")
        check(r["own_ratio"] > 1.0, f"mesh (d): the pod's own mean {r['own_ratio']} times the "
                                    f"bound (the check cannot tell it from the mean)")
        check(r["err_half"] <= 0.5 + 1e-4 and r["err_frac"] <= 1e-3,
              f"mesh (d): error feedback up to {r['err_half']} scales, {r['err_frac']} from "
              f"whole steps of the scale")
        check(r["max_diff"] < 1e-3, f"mesh (d): {r['max_diff']} from the uncompressed step")
        check(r["hop"]["calls"]["all-gather"] == 2 * r["leaves"]
              and r["hop"]["bytes"]["all-gather"] == r["numel"] + 4 * r["leaves"],
              f"mesh (d): pod hop {r['hop']} for {r['numel']} elements in {r['leaves']} leaves")
        check(r["f32"]["bytes"]["all-reduce"] >= 4 * r["numel"], f"mesh (d): f32 {r['f32']}")
    r = ranks[0]
    print(f"mesh (d): compressed step on a {MESH_PODS} (pod, data, model) mesh, "
          f"{cfg.data.embedding_rows}-row tables: losses {[rr['losses'] for rr in ranks]}; the "
          f"first update's gradients within {max(rr['ratio'] for rr in ranks):.4g} of the "
          f"quantization bound from the f32 pod-and-data mean (the pod's own mean: "
          f"{min(rr['own_ratio'] for rr in ranks):.4g} of it), error feedback up to "
          f"{max(rr['err_half'] for rr in ranks):.6g} scales and within "
          f"{max(rr['err_frac'] for rr in ranks):.3g} of whole steps; parameters one "
          f"step on within {max(rr['max_diff'] for rr in ranks):.3g} of the uncompressed step's "
          f"(bound 1e-3, at most 2 lr apart after AdamW's first step); pod hop "
          f"{r['hop']['bytes']['all-gather']} int8+scale bytes per rank in "
          f"{r['hop']['calls']['all-gather']} all-gathers against "
          f"{r['f32']['bytes']['all-reduce']} bytes of f32 all-reduce for "
          f"{r['numel']} parameters; {time.perf_counter() - t0:.1f} s with the spawn; card {card}")


def phase_mesh(dev, spec, root: Path, fused_batches: dict) -> dict:
    """The meshed paths at full RM2 width, as ranks that share the card
    (``launch.mesh.run_spmd``; transport ``gloo-staged``):

    (a) ``preprocess_global`` on a (4, 2) (data, model) mesh over pids 0-3
        of ``phase_store``'s classic files and two of its dedup-4 files
        (each rank stages each once), under presto, hybrid, disagg and
        unfused: every gathered global
        batch bitwise the one-device batch, each rank's bytes per batch the
        hopped families' page and batch bytes over the data axis (gen
        pages regathered under disagg), presto with no collective call;
    (b) the row-sharded bag over RM2's full tables on a (1, 4) mesh against
        the one-device bag (2e-5) and its table gradient (1e-6);
    (c) three meshed train steps on a (1, 2) mesh (the full tables split
        over model) against three one-device steps from the same params
        and batches (losses within 1e-5);
    (d) the int8-compressed step on a (2, 1, 1) (pod, data, model) mesh at
        rm2 widths with MESH_PODS_ROWS-row tables: the loss falls over 2
        steps, the first update's gradients lie within the quantization
        bound of the f32 mean (where the pod's own mean does not), the
        error feedback is the pod's residual, one step lands within 1e-3 of
        the uncompressed meshed step, and the pod hop carries int8 (numel
        bytes and a 4-byte scale per leaf);
    (e) ``presto_vs_disagg`` as a user runs it (its system level on its
        default (8, 2) mesh of ranks), each placement's bytes per rank
        against the family bytes.

    Returns the launch counts of (a)'s placements (summed over ranks) and
    of the example's kernel level."""
    import dataclasses

    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.data.synth import RM_CONFIGS, SyntheticRecSysSource
    from repro_torch.launch.mesh import choose_transport, rank_devices, run_spmd
    from repro_torch.models import recsys as RS

    t_phase = time.perf_counter()
    card = card_line(CARD)
    work = root / "mesh"
    work.mkdir()
    world = int(np.prod(MESH_PRE))
    ranks_on = rank_devices(world, dev)
    print(f"mesh: world of {world} ranks as a {MESH_PRE} (data, model) mesh, rank -> device "
          f"{[str(d) for d in ranks_on]}, transport {choose_transport(ranks_on)} (NCCL refuses "
          f"two ranks on one device); card {card}")

    # (a) the one-device batches the gathered ones must equal, as files
    dcfg = dataclasses.replace(RM_CONFIGS[MAIN_CONFIG], dup_factor=DEDUP_FACTOR)
    dspec = TransformSpec.from_source(SyntheticRecSysSource(dcfg, rows=MAIN_ROWS, seed=0))
    dengine = TorchPreStoEngine(dspec)
    dstore = PartitionedStore(4, 4, None, root=str(root / "dedup"))
    wants = [("classic", pid, fused_batches[pid]) for pid in range(4)] + \
        [("dedup", pid, dengine.produce_batch(dstore, pid)) for pid in MESH_DEDUP_PIDS]
    for kind, pid, mb in wants:
        for key, v in mb.items():
            np.save(work / f"{kind}-{pid}-{key}.npy", v.cpu().numpy())
    del wants
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_spmd(mesh_preprocess_rank, MESH_PRE, ("data", "model"), device=dev,
                     args=(spec, dspec, str(root), str(work)))
    by_path = {}
    for name, (placement, kernel_mode) in MESH_PLACEMENTS.items():
        per = [r["placements"][name] for r in ranks]
        counts = {k: sum(p["launches"][k] for p in per) for k in per[0]["launches"]}
        by_path[f"mesh {name}"] = {1: counts}
        check_launches(f"mesh {name}", TorchPreStoEngine(
            spec, placement=placement, kernel_mode=kernel_mode).lowered_plan, {1: counts})
        ms = [max(p["ms"][i] for p in per) for i in range(len(per[0]["ms"]))]
        print(f"mesh (a) {name}: host families {per[0]['host_families'] or '-'}, "
              f"{per[0]['bytes']} bytes per rank per global batch ({per[0]['calls']} calls per "
              f"rank over 6 batches), ms per global batch (max over ranks, CUDA events around "
              f"copy-in, Transform and hops, after a warm-up batch) {[round(x, 3) for x in ms]} "
              f"median {statistics.median(ms):.3f}, of it in the hops (host clock, max over "
              f"ranks) {max(p['hop_ms'] for p in per):.3f}; launches {counts}")
    stage = [max(r["stage_ms"][i] for r in ranks) for i in range(len(ranks[0]["stage_ms"]))]
    print(f"mesh (a): 6 global batches x 4 placements bitwise the one-device batches; a rank's "
          f"staging (file read, inflation, page build, shard, pin; host clock, max over ranks) "
          f"{[round(x, 1) for x in stage]} ms; peak {max(r['peak'] for r in ranks)} bytes on a "
          f"rank; {time.perf_counter() - t0:.1f} s with the spawn; card {card}")

    # (b) the row-sharded bag at RM2's full tables
    cfg = train_config()
    mb = fused_batches[0]
    ids = {k: mb[k].cpu().numpy() for k in ("multi_hot_ids", "lengths", "one_hot_ids")}
    np.savez(work / "ids.npz", **ids)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tables = seeded_dlrm(cfg, dev).tables
    w = mesh_weights(cfg, mb["lengths"].shape[0], dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    # the witness is the plain bag, whose F.embedding_bag the row-sharded bag
    # shares; the one-device kernels sum in another order and are held to it
    # and to float64 by phase_embedding
    pooled = RS.embedding_bag_plain(tables, mb["multi_hot_ids"], mb["lengths"],
                                    mb["one_hot_ids"])
    (pooled * w).sum().backward()
    b.record()
    b.synchronize()
    one_ms, one_peak = a.elapsed_time(b), torch.cuda.max_memory_allocated()
    # rows checked: those the first 16 samples touch, and 64 untouched
    rows_t, rows_r = [], []
    s, L = cfg.data.n_sparse, cfg.data.max_sparse_len
    for t in range(cfg.n_tables):
        if t < s:
            used = mb["multi_hot_ids"][:16, t][
                torch.arange(L, device=dev) < mb["lengths"][:16, t, None]]
        else:
            used = mb["one_hot_ids"][:16, t - s]
        used = used[(used >= 0) & (used < cfg.data.embedding_rows)].unique()
        rows_t.append(torch.full_like(used, t))
        rows_r.append(used)
    rng = np.random.default_rng(MESH_SEED)
    rows_t.append(torch.from_numpy(rng.integers(0, cfg.n_tables, 64)).to(dev))
    rows_r.append(torch.from_numpy(rng.integers(0, cfg.data.embedding_rows, 64)).to(dev))
    t_i, r_i = torch.cat(rows_t).long(), torch.cat(rows_r).long()
    np.save(work / "pooled.npy", pooled.detach().cpu().numpy())
    np.savez(work / "grad.npz", t=t_i.cpu().numpy(), row=r_i.cpu().numpy(),
             grad=tables.grad[t_i, r_i].cpu().numpy(), pooled=str(work / "pooled.npy"))
    sq = table_sq(tables.grad)
    del tables, w, pooled
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_spmd(mesh_embedding_rank, MESH_EMB, ("data", "model"), device=dev,
                     args=(cfg, str(work / "ids.npz"), str(work / "grad.npz")))
    pooled_err = ranks[0]["pooled_err"]
    grad_err = max(r["grad_err"] for r in ranks)
    sq_mesh = sum(r["sq"] for r in ranks)
    check(pooled_err <= 2e-5, f"mesh (b): pooled max |diff| {pooled_err}")
    check(grad_err <= 1e-6, f"mesh (b): table-gradient rows max |diff| {grad_err}")
    check(sum(r["rows_checked"] for r in ranks) == len(t_i), "mesh (b): rows checked")
    check(abs(sq_mesh - sq) <= 1e-5 * sq, f"mesh (b): gradient sum of squares {sq_mesh} vs {sq}")
    print(f"mesh (b): {cfg.n_tables} x {cfg.data.embedding_rows} x {cfg.emb_dim} tables over "
          f"model = {MESH_EMB[1]}, B = {mb['lengths'].shape[0]}: pooled max |diff| "
          f"{pooled_err:.3g} (bound 2e-5), {len(t_i)} table-gradient rows max |diff| "
          f"{grad_err:.3g} (bound 1e-6), gradient sum of squares {sq_mesh:.9g} against "
          f"{sq:.9g}; bag forward+backward {max(r['ms'] for r in ranks):.3f} ms (max over "
          f"ranks, CUDA events; the psums staged) against {one_ms:.3f} ms on one device; peak "
          f"{max(r['peak'] for r in ranks)} bytes per rank against {one_peak} on one device; "
          f"all-reduce {ranks[0]['bytes']['all-reduce']} bytes per rank in "
          f"{max(r['hop_ms'] for r in ranks):.3f} ms (host clock, max over ranks); "
          f"{time.perf_counter() - t0:.1f} s with the spawn; card {card}")

    # (c) the meshed train step against the one-device step, full tables
    paths = []
    for pid in range(MESH_TRAIN_STEPS):
        paths.append(str(work / f"batch-{pid}.pt"))
        torch.save({k: v.cpu() for k, v in fused_batches[pid].items()}, paths[-1])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = seeded_dlrm(cfg, dev)
    opt, state, loss = train_setup(cfg, model)
    from repro_torch.train import make_train_step

    step = make_train_step(loss, opt)
    one_losses, one_ms = [], []
    for pid in range(MESH_TRAIN_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, metrics = step(state, fused_batches[pid])
        b.record()
        b.synchronize()
        one_losses.append(float(metrics["loss"]))
        one_ms.append(a.elapsed_time(b))
    one_peak = torch.cuda.max_memory_allocated()
    del model, opt, state, loss, step, metrics
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    t0 = time.perf_counter()
    ranks = run_spmd(mesh_train_rank, MESH_TRAIN, ("data", "model"), device=dev,
                     args=(cfg, paths))
    worst = max(abs(x - y) for r in ranks for x, y in zip(r["losses"], one_losses))
    check(worst <= 1e-5, f"mesh (c): losses {[r['losses'] for r in ranks]} against "
                         f"{one_losses}")
    print(f"mesh (c): {MESH_TRAIN_STEPS} train steps on a {MESH_TRAIN} mesh, tables "
          f"{ranks[0]['tables']} per rank, losses {ranks[0]['losses']} against one device's "
          f"{one_losses} (max |diff| {worst:.3g}, bound 1e-5); step ms per rank "
          f"{[[round(x, 3) for x in r['ms']] for r in ranks]} against one device's "
          f"{[round(x, 3) for x in one_ms]} (CUDA events), of it in the hops "
          f"{[round(r['hop_ms'], 3) for r in ranks]} ms a step (host clock); peak per rank "
          f"{[r['peak'] for r in ranks]} bytes against {one_peak} on one device; {free} bytes "
          f"free before the spawn; {time.perf_counter() - t0:.1f} s with the spawn; card {card}")

    # (d) the int8-compressed step across pods at cut rows
    mesh_pods(dev, dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, embedding_rows=MESH_PODS_ROWS)), paths[0], card)

    # (e) the example as a user runs it: kernel level, then its system level
    from repro_torch.examples import presto_vs_disagg
    from repro_torch.kernels import fused

    t0 = time.perf_counter()
    fused.reset_launches()
    pvd = presto_vs_disagg.main([])
    by_path["presto_vs_disagg"] = {1: dict(fused.LAUNCHES)}
    ranks = pvd["system"]
    cfg_x = presto_vs_disagg.SYSTEM_CONFIG
    xspec = TransformSpec.from_source(SyntheticRecSysSource(cfg_x, rows=cfg_x.rows_per_partition))
    check(len(ranks) == int(np.prod(MESH_EXAMPLE)), f"presto_vs_disagg: {len(ranks)} ranks")
    for rr in ranks:
        check(rr["presto"]["calls"] == 0, "presto_vs_disagg: presto made a collective call")
        for placement in ("hybrid", "disagg"):
            want = family_hop_bytes(xspec, cfg_x.rows_per_partition,
                                    rr[placement]["host_families"], MESH_EXAMPLE[0])
            check(rr[placement]["bytes"]["collective-permute"] == want
                  and sum(rr[placement]["bytes"].values()) == want,
                  f"presto_vs_disagg {placement}: {rr[placement]['bytes']} against {want}")
    print(f"mesh (e): presto_vs_disagg, kernel level at rm5 (fused {pvd['fused_ms']:.4f}, "
          f"unfused {pvd['unfused_ms']:.4f} ms/partition, CUDA events, best of 10, launches "
          f"{by_path['presto_vs_disagg'][1]}), system level on {len(ranks)} ranks "
          f"{MESH_EXAMPLE}: bytes per rank equal the family bytes; "
          f"{time.perf_counter() - t0:.1f} s; card {card}")
    print(f"mesh: {time.perf_counter() - t_phase:.1f} s in all")
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


def bag_inputs(cfg, dev, rng, batch: dict | None = None):
    """The bag's (multi_ids, lengths, one_ids) at BAG_ROWS rows: `batch`'s
    where given (a delivered batch), else drawn as the Transform shapes
    them: lengths near the config's mean, ids skewed towards small raw ids
    then hashed over the table, generated ids on one of 1,025 buckets."""
    if batch is not None:
        return batch["multi_hot_ids"], batch["lengths"], batch["one_hot_ids"]
    d = cfg.data
    b, s, L, g, r = BAG_ROWS, d.n_sparse, d.max_sparse_len, d.n_generated, d.embedding_rows
    lengths = np.clip(rng.poisson(d.avg_sparse_len, (b, s)), 0, L)
    u = rng.random((b, s, L))
    multi = (u * u * (d.id_space - 1)).astype(np.int64) * 2654435761 % d.id_space % r
    one = rng.integers(0, d.bucket_size + 1, (b, g)) * 487 % r
    return tuple(torch.from_numpy(x.astype(np.int32)).to(dev) for x in (multi, lengths, one))


def hold_bag_grad(name: str, grad, grad_out, counts, keys, r: int) -> float:
    """A table gradient against the float64 sum of its terms
    grad_out[b, t] / count[b, t], row by row within (k + 2) 2^-24 S (k the
    row's contributions, S the sum of their magnitudes: float32 recursive
    summation's bound with each quotient's rounding), and exactly 0 on every
    row no position touches; a table at a time.  Returns the largest gap."""
    t, _, d = grad.shape
    p = keys.shape[1]
    flat = keys.reshape(-1)
    worst = 0.0
    for i in range(t):
        pos = torch.nonzero((flat >= i * r) & (flat < (i + 1) * r)).squeeze(1)
        row = flat[pos].long() - i * r
        term = grad_out[pos // p, i].double() / counts[pos // p, i].clamp_min(1).double()[:, None]
        rows, inv = torch.unique(row, return_inverse=True)
        want = torch.zeros(len(rows), d, dtype=torch.float64, device=grad.device)
        mag = torch.zeros_like(want)
        want.index_add_(0, inv, term)
        mag.index_add_(0, inv, term.abs())
        k = torch.bincount(inv, minlength=len(rows)).double()[:, None]
        gap = (grad[i, rows].double() - want).abs()
        check(bool((gap <= (k + 2) * 2.0**-24 * mag).all()),
              f"{name}: table {i}'s gradient is past the float64 bound")
        touched = torch.nonzero(grad[i].ne(0).any(1)).squeeze(1)
        check(bool(torch.isin(touched, rows).all()), f"{name}: an untouched row of table {i}")
        worst = max(worst, float(gap.max()) if gap.numel() else 0.0)
    return worst


def bag_device_ms(fn, reps: int, flush: torch.Tensor) -> float | None:
    """The mean device time a call of `fn` from the profiler, everything it
    runs on the card (fills and memsets included: the plain backward's
    zero-fill is part of its work), L2 flushed by a ``bitwise_not_`` that is
    left out; None where three sessions held no device records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "bitwise_not" not in e.key)
        if total > 0:
            return total / reps / 1e3
    return None


def bag_timings(tables, multi, lengths, one, grad_out, counts, keys, errs) -> list:
    """The bag's kernel-table rows at rm2's shapes: the forward and the
    backward (its sort included), each beside its bytes' bound, the plain
    version and ``F.embedding_bag`` over the valid ids in "mean" mode (the
    one PyTorch call that computes the same function) as the yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding as emb
    from repro_torch.models import recsys as RS

    t, r, d = tables.shape
    b = multi.shape[0]
    flat = keys.reshape(-1)
    valid = flat < t * r
    n_valid = int(valid.sum())
    ids = flat[valid].long()
    sizes = counts.reshape(-1).long()
    offsets = torch.cumsum(sizes, 0) - sizes
    flush = torch.empty(64 << 20, dtype=torch.int32, device=tables.device)  # 256 MB > L2
    x = tables.detach()
    shapes = (tuple(tables.shape), tuple(multi.shape))

    def yard():
        return F.embedding_bag(ids, tables.view(t * r, d), offsets, mode="mean")

    plain_out, yard_out = RS.embedding_bag_plain(tables, multi, lengths, one), yard()
    flat_grad = grad_out.reshape(b * t, d)
    cases = {
        "embedding_bag": dict(
            run=lambda: emb.forward(x, multi, lengths, one),
            plain=lambda: RS.embedding_bag_plain(x, multi, lengths, one),
            yard=lambda: F.embedding_bag(ids, x.view(t * r, d), offsets, mode="mean"),
            nbytes=(n_valid * d + multi.numel() + lengths.numel() + one.numel() + b * t * d
                    + b * t + keys.numel()) * 4,
            ops=n_valid * d + b * t * d),
        "embedding_bag.backward": dict(
            run=lambda: emb.backward(grad_out, counts, keys, *shapes),
            plain=lambda: torch.autograd.grad(plain_out, tables, grad_out, retain_graph=True),
            yard=lambda: torch.autograd.grad(yard_out, tables, flat_grad, retain_graph=True),
            nbytes=(t * r * d + b * t * d + keys.numel() + b * t) * 4, ops=2 * n_valid * d),
    }
    rows = []
    for name, c in cases.items():
        bound_ms, bound_by = bound(c["nbytes"], c["ops"])
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "shape": [b, t, d], "bytes": c["nbytes"], "bound_ms": bound_ms, "bound_by": bound_by,
            "ms": time_ms(c["run"], 20, flush), "device_ms": bag_device_ms(c["run"], 10, flush),
            "plain_ms": time_ms(c["plain"], 5, flush),
            "plain_device_ms": bag_device_ms(c["plain"], 5, flush), "library_ms": None,
            "yardstick": 'F.embedding_bag(valid ids, offsets, mode="mean")'
                         + (" and its backward" if name.endswith("backward") else ""),
            "yardstick_ms": time_ms(c["yard"], 10, flush),
            "yardstick_device_ms": bag_device_ms(c["yard"], 10, flush),
            "max_abs_err": errs[name], "valid_positions": n_valid, "more_shapes": [],
        }
        print(f"kernel {name} rm2 {(b, t, d)}: {row['ms']:.5f} ms (device "
              f"{fmt_ms(row['device_ms'])}), {row['bytes']} bytes, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms "
              f"(device {fmt_ms(row['plain_device_ms'])}), yardstick {row['yardstick_ms']:.4f} "
              f"ms (device {fmt_ms(row['yardstick_device_ms'])}) [{row['yardstick']}]; "
              f"{n_valid} valid positions of {keys.numel()}")
        rows.append(row)
    return rows


def phase_embedding(dev, rm2_batch: dict, errs: dict) -> list:
    """The DLRM's embedding bag kernels against the plain version at rm2's
    shapes (the main path's first delivered batch) and rm1's (drawn), the
    tables at full size: the forward to rtol 1e-6 (both sum the valid rows
    in position order), the kernel's and the plain gradient each within
    ``hold_bag_grad``'s float64 bound, one launch of each pass, and the same
    gradient bits from a second backward.  Then the rm2 rows of the kernel
    table (``bag_timings``), returned without their launch counts."""
    from repro_torch.configs.registry import get_recsys
    from repro_torch.kernels import embedding as emb
    from repro_torch.kernels import fused
    from repro_torch.models import recsys as RS

    rng = np.random.default_rng(BAG_SEED)
    rows = []
    for name in ("rm2", "rm1"):
        t0 = time.perf_counter()
        cfg = get_recsys(name)
        t, r, d = cfg.n_tables, cfg.data.embedding_rows, cfg.emb_dim
        multi, lengths, one = bag_inputs(cfg, dev, rng, rm2_batch if name == "rm2" else None)
        gen = torch.Generator(dev).manual_seed(BAG_SEED)
        tables = torch.empty((t, r, d), device=dev).normal_(generator=gen).mul_(0.01)
        tables.requires_grad_(True)
        grad_out = torch.empty((multi.shape[0], t, d), device=dev).normal_(generator=gen)
        fused.reset_launches()
        pooled = RS.embedding_bag(tables, multi, lengths, one)
        pooled.backward(grad_out)
        grad, tables.grad = tables.grad, None
        check_bag_launches(f"bag {name}", fused.LAUNCHES, 1)
        plain = RS.embedding_bag_plain(tables, multi, lengths, one)
        plain.backward(grad_out)
        plain_grad, tables.grad = tables.grad, None
        pooled, plain = pooled.detach(), plain.detach()
        torch.testing.assert_close(pooled, plain, rtol=1e-6, atol=0,
                                   msg=lambda m: f"bag {name} forward: {m}")
        _, counts, keys = emb.forward(tables.detach(), multi, lengths, one)
        gap = hold_bag_grad(f"bag {name}", grad, grad_out, counts, keys, r)
        plain_gap = hold_bag_grad(f"bag {name} plain", plain_grad, grad_out, counts, keys, r)
        diff = max(float((grad[i] - plain_grad[i]).abs().max()) for i in range(t))
        errs["embedding_bag"] = max(errs.get("embedding_bag", 0.0), max_abs_err(pooled, plain))
        errs["embedding_bag.backward"] = max(errs.get("embedding_bag.backward", 0.0), diff)
        del plain_grad
        again = emb.backward(grad_out, counts, keys, tuple(tables.shape), tuple(multi.shape))
        check(torch.equal(grad.view(torch.int32), again.view(torch.int32)),
              f"bag {name}: two backward calls gave different bits")
        del again, grad
        print(f"bag {name}: tables {(t, r, d)}, {multi.shape[0]} rows, "
              f"{int((keys < t * r).sum())} valid positions of {keys.numel()}; forward within "
              f"{max_abs_err(pooled, plain):.3g} of plain (rtol 1e-6), gradient within the "
              f"float64 bound (largest gap {gap:.3g}; plain's {plain_gap:.3g}; kernel against "
              f"plain {diff:.3g}), bit-identical twice, one launch each pass; "
              f"{time.perf_counter() - t0:.1f} s")
        if name == "rm2":
            rows = bag_timings(tables, multi, lengths, one, grad_out, counts, keys, errs)
        del tables, pooled, plain, grad_out, counts, keys
        gc.collect()
        torch.cuda.empty_cache()
    return rows


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
    from repro_torch.kernels import fused
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
    fused.reset_launches()
    for device in ("cpu", dev):
        opt, state, loss = train_setup(cfg, RS.params_from_numpy(tree, cfg, device))
        step = make_train_step(loss, opt)
        losses = []
        for mb in batches:
            state, metrics = step(state, {k: v.to(device) for k, v in mb.items()})
            losses.append(float(metrics["loss"]))
        runs[str(device)] = (losses, RS.params_to_numpy(state["params"]))
    (cpu_losses, cpu_params), (losses, params) = runs["cpu"], runs[str(dev)]
    check_bag_launches("train parity", fused.LAUNCHES, len(batches))
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
    fused.reset_launches()
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
    check_bag_launches("train", fused.LAUNCHES, len(batches))
    times = [a.elapsed_time(b) for a, b in ms]
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"full-width train losses {losses}")
    step_ms = statistics.median(times)
    rows = batches[0]["labels"].shape[0]
    print(f"train: {len(batches)} steps of {rows} rows, losses {losses}")
    print(f"train: step time {step_ms:.3f} ms (CUDA events, median of the {len(times)} "
          f"unprofiled steps; all {[round(t, 3) for t in times]}), {rows / step_ms * 1e3:.1f} "
          f"training samples/s; card {card_line(CARD)}")
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
    check_bag_launches("ingest", launches, 3)
    check(all(np.isfinite(ingest_losses)) and ingest_losses[-1] < ingest_losses[0],
          f"ingest losses {ingest_losses} do not fall on the repeated partition")
    peak = torch.cuda.max_memory_allocated()
    print(f"train ingest: 3 steps on pid 0's staged pages, losses {ingest_losses} (falling), "
          f"step times {[round(a.elapsed_time(b), 3) for a, b in ingest_ms]} ms, launches "
          f"{launches}")
    print(f"train: peak memory {peak} bytes ({peak / 2**30:.2f} GiB) of "
          f"{torch.cuda.get_device_properties(dev).total_memory} (max_memory_allocated); "
          f"card {card_line(CARD)}")

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
    check_bag_launches("pipeline", pipe_launches, PIPELINE_STEPS)
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
          f"for the direct step above; launches {pipe_launches}; card {card_line(CARD)}")
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
    # a range named like a span on the device's timeline is not a kernel
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

    # both passes launch under dlrm.embedding_bag; the backward's also lie
    # under the autograd engine's span of its node
    emb = part(lambda k: k == "dlrm.embedding_bag")
    emb_b = part(lambda k: k.startswith("autograd::engine::evaluate_function: "
                                        "EmbeddingBagBackward"))
    emb_f = emb - emb_b
    opt = part(lambda k: k == "adamw")
    rest = busy - emb - opt
    print(f"train split (profiler, one step): device busy {busy / 1e3:.3f} ms; embedding "
          f"forward {emb_f / 1e3:.3f} ms, embedding backward {emb_b / 1e3:.3f} ms, MLPs + "
          f"interaction + loss {rest / 1e3:.3f} ms, optimizer {opt / 1e3:.3f} ms")
    for key, count, t in sorted(kernels, key=lambda r: -r[2])[:12]:
        print(f"train split:   {t / 1e3:9.3f} ms  x{count}  {key[:90]}")
    return busy / 1e3


class HostWatch:
    """The least host memory available (``MemAvailable``) while the block
    runs, sampled every quarter second by a thread."""

    def __enter__(self):
        self.before = self.least = host_free_bytes()
        self.parent_rss = rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.25):
            self.least = min(self.least, host_free_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def rss_bytes() -> int | None:
    """This process's resident bytes now (``VmRSS``), None where the kernel
    does not say (``ru_maxrss`` is no help: a spawned rank keeps its
    spawner's mark across the exec)."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    return None


def rank_memory(dev) -> dict:
    """A rank's host RSS at the end of its run, the card's most reserved
    bytes, and the most pinned bytes its host allocator held (the staged
    collectives' buffers; None where this PyTorch does not count them)."""
    try:
        stats = torch.cuda.host_memory_stats()
    except (AttributeError, RuntimeError):  # a PyTorch without the pinned allocator's stats
        stats = {}
    return {"rss": rss_bytes(),
            "reserved": torch.cuda.max_memory_reserved(dev),
            "pinned": stats.get("allocated_bytes.all.peak", stats.get("allocated_bytes.peak"))}


def memory_line(tag: str, watch: HostWatch, mems: list) -> str:
    """`tag`'s world: the host's memory around it and the ranks'
    ``rank_memory`` marks `mems`, by rank."""
    return (f"{tag}: host memory available {watch.before} bytes before the spawn (this "
            f"process's RSS {watch.parent_rss}), least {watch.least} during the world; by "
            f"rank: RSS at the end {[m['rss'] for m in mems]}, "
            f"card bytes reserved at most {[m['reserved'] for m in mems]}, pinned host bytes "
            f"{[m['pinned'] for m in mems]}")


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
          f"{launches}, {wall:.2f} s in all; card {card_line(CARD)}")
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
          f"card {card_line(CARD)}")
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
          f"{base - nbytes}, peak above the state {peak - nbytes} bytes; card {card_line(CARD)}")
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
    trainer = ElasticTrainer(make_mesh=lambda: dev, make_state=make_state,
                             make_step=lambda device: step, state_shardings=None, ckpt=ck,
                             checkpoint_every=2)
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
    done, metrics = trainer.run(enumerate(batches), max_steps=ELASTIC_STEPS)
    state, trainer.state = trainer.state, None
    torch.cuda.synchronize()
    drill_s = time.perf_counter() - t0
    check(done == int(state["step"]) == ELASTIC_STEPS and ck.latest_step() == ELASTIC_STEPS,
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
          f"{int(state['step'])} (loss {metrics['loss']:.4f}); largest |resumed - "
          f"straight| {worst:.3g} (bound 1e-5); {drill_s:.2f} s; card {card_line(CARD)}")
    check(worst < 1e-5, f"elastic: resumed parameters {worst} from the straight run")
    del state, straight, metrics, batches, trainer
    torch.cuda.empty_cache()
    return {1: launches}


def mesh_elastic_config():
    """RM2's feature geometry and MLPs with MESH_ELASTIC_ROWS-row tables."""
    import dataclasses

    full = train_config()
    return dataclasses.replace(full, data=dataclasses.replace(
        full.data, embedding_rows=MESH_ELASTIC_ROWS))


def mesh_elastic_opt():
    from repro_torch.train import adamw, warmup_cosine

    return adamw(warmup_cosine(*TRAIN_LR))


def mesh_elastic_state(where, cfg, dtype=torch.float32):
    """make_state of the meshed drill: the MESH_SEED DLRM in `dtype` (a
    rank's blocks on a mesh) and zero AdamW state."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train import init_state

    if isinstance(where, Mesh):
        model = seeded_dlrm(cfg, where.device, ShardingRules.make(where))
    else:
        model = seeded_dlrm(cfg, where)
    return init_state(model.to(dtype), mesh_elastic_opt())


def mesh_elastic_specs(mesh, cfg):
    """state_shardings of the meshed drill."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import recsys as RS

    return RS.state_pspecs(cfg, ShardingRules.make(mesh), mesh_elastic_opt())


def mesh_elastic_step(where, cfg, dtype=torch.float32):
    """make_step of the meshed drill: the (meshed) train step on the rank's
    rows of each host batch, moved to the rank's device, its floats in
    `dtype`."""
    from repro_torch.distributed.sharding import ShardingRules, shard
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import recsys as RS
    from repro_torch.train import make_train_step

    def on(v, device):
        return v.to(device, dtype if v.is_floating_point() else v.dtype)

    if not isinstance(where, Mesh):
        step = make_train_step(lambda m, b: RS.loss_fn(m, b, cfg), mesh_elastic_opt())
        return lambda state, batch: step(state, {k: on(v, where) for k, v in batch.items()})
    rules = ShardingRules.make(where)
    step = make_train_step(lambda m, b: RS.loss_fn(m, b, cfg, rules), mesh_elastic_opt(),
                           rules=rules, param_specs=RS.flat_param_pspecs(cfg, rules))
    row = rules.pspec("batch")
    return lambda state, batch: step(
        state, {k: on(shard(v, where, row), where.device) for k, v in batch.items()})


class BatchFiles:
    """``(step, batch)`` from ``torch.save`` files, read anew by each rank
    of an incarnation (pickled as their paths)."""

    def __init__(self, paths):
        self.paths = [str(p) for p in paths]

    def __iter__(self):
        for i, path in enumerate(self.paths):
            yield i, torch.load(path)


@contextlib.contextmanager
def relu_signs():
    """Records ``x > 0`` of every ``torch.relu`` input while open (the
    DLRM's MLPs call it once a hidden layer), in call order."""
    seen, relu = [], torch.relu

    def recording(x):
        seen.append((x > 0).cpu())
        return relu(x)

    torch.relu = recording
    try:
        yield seen
    finally:
        torch.relu = relu


def mesh_elastic_straight(where, cfg, batches) -> dict:
    """A straight f32 run of the drill's step on `where` (a rank's mesh or
    the card): the final state and loss, and the first step's ReLU signs
    and table gradient (this rank's rows)."""
    state, step = mesh_elastic_state(where, cfg), mesh_elastic_step(where, cfg)
    out = {}
    for i, batch in batches:
        if i == 0:
            with relu_signs() as out["signs"]:
                state, metrics = step(state, batch)
            out["grad0"] = state["params"].tables.grad.detach().clone()
        else:
            state, metrics = step(state, batch)
    return dict(out, state=state, loss=float(metrics["loss"]))


def mesh_elastic_straight_rank(mesh, cfg, batches, ckpt_dir: str) -> dict:
    """A straight f32 run on the drill's mesh (no checkpoint): its largest
    distance from the blocks of the resumed run's final checkpoint,
    restored into a fresh state; and, for the comparison with one device,
    its final parameter blocks, specs and the first step's ReLU signs and
    table-gradient block, on the host."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import recsys as RS
    from repro_torch.train import CheckpointManager

    run = mesh_elastic_straight(mesh, cfg, batches)
    params = run["state"]["params"]
    ck = CheckpointManager(ckpt_dir)
    resumed = ck.restore(ck.latest_step(), target=mesh_elastic_state(mesh, cfg), mesh=mesh,
                         specs=mesh_elastic_specs(mesh, cfg))
    with torch.no_grad():
        worst = max(float((a - b).abs().max()) for a, b in
                    zip(resumed["params"].parameters(), params.parameters()))
    peak = torch.cuda.max_memory_allocated(mesh.device) if mesh.device.type == "cuda" else 0
    # numpy, which pickles by value: a tensor would go by a shared-memory
    # handle that dies with the rank
    return {"worst": worst, "loss": run["loss"], "step": int(resumed["step"]), "peak": peak,
            "params": {k: p.detach().cpu().numpy() for k, p in params.named_parameters()},
            "specs": RS.flat_param_pspecs(cfg, ShardingRules.make(mesh)),
            "signs": [s.numpy() for s in run["signs"]], "grad0": run["grad0"].cpu().numpy()}


def param_drift(got: dict, want: dict, atol: float) -> tuple:
    """(largest |got - want|, entries more than `atol` apart) over leaves
    by name; `got` holds blocks of `want`'s leaves as ``(block, index)``."""
    worst, over = 0.0, 0
    with torch.no_grad():
        for name, (block, index) in got.items():
            d = (torch.as_tensor(block).to(want[name].device) - want[name][index]).abs()
            worst, over = max(worst, float(d.max())), over + int((d > atol).sum())
    return worst, over


def sample_rows(batch: dict, samples: list, n_tables: int, rows: int) -> torch.Tensor:
    """(T, R) bool: the table rows that `samples` of `batch` pool."""
    out = torch.zeros((n_tables, rows), dtype=torch.bool)
    if not samples:
        return out
    ids, lengths = batch["multi_hot_ids"][samples].long(), batch["lengths"][samples]
    one = batch["one_hot_ids"][samples].long()
    s, L = ids.shape[1:]
    table = torch.arange(s)[None, :, None].expand_as(ids)
    ok = (torch.arange(L) < lengths[..., None]) & (ids >= 0) & (ids < rows)
    out[table[ok], ids[ok]] = True
    table = (s + torch.arange(one.shape[1]))[None].expand_as(one)
    ok = (one >= 0) & (one < rows)
    out[table[ok], one[ok]] = True
    return out


def sha256_files(d: Path) -> dict:
    import hashlib

    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(d.iterdir())}


def phase_mesh_elastic(dev, work: Path) -> dict:
    """``ElasticTrainer`` over meshes: ranks that share the card
    (``launch.mesh.World``), RM2's feature geometry and MLPs with
    MESH_ELASTIC_ROWS-row tables, checkpoints every 2 steps in the global
    format.  The incarnation on MESH_ELASTIC fails at step 3; its ranks exit
    and release their device memory (``mem_get_info`` before the spawn and
    after the world ends); the step-2 checkpoint it wrote is byte for byte
    (sha256 of each file) a one-device save of the same state (restored on
    one device, then saved); the drill resumes (i) on MESH_ELASTIC, its
    parameters within 1e-5 of a straight run on that mesh, and (ii) on one
    device.

    (ii) crosses topologies.  The same drill in f64 holds its resume, and
    the mesh's first two steps, within 1e-5 of a straight one-device run.
    In f32 the mesh pools the bag in another order; the one-ulp
    differences flip a few ReLUs of the first step, which changes the
    gradient of every table row those samples pool, turns small gradient
    entries (below AdamW's eps) to the other sign, and moves the
    parameters of every later step.  The phase measures that on the first
    step (ReLU signs, table-gradient signs and their size, and the rows the
    flipped samples pool) and holds the f32 resume to the train rule:
    every entry within 2 lr a step, and past lr/100 no more entries than a
    straight run on the mesh, with no restart, has (the first step's
    flips, which both histories share) and 1% of the entries more (steps
    2 and 3, which the resume runs on another topology).
    Returns the launch counts of producing the drill's 4 batches."""
    import functools

    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.storage import PartitionedStore
    from repro_torch.data.synth import SyntheticRecSysSource
    from repro_torch.distributed.sharding import block_index
    from repro_torch.kernels import fused
    from repro_torch.launch.mesh import Mesh, World
    from repro_torch.train import CheckpointManager, ElasticTrainer

    t_phase = time.perf_counter()
    card = card_line(CARD)
    cfg = mesh_elastic_config()
    src = SyntheticRecSysSource(cfg.data, rows=MAIN_ROWS)
    engine = TorchPreStoEngine(TransformSpec.from_source(src))
    store = PartitionedStore(ELASTIC_STEPS, num_devices=4, source=src)
    work.mkdir(parents=True, exist_ok=True)
    paths = []
    fused.reset_launches()
    for pid in range(ELASTIC_STEPS):
        batch = engine.produce_batch(store, pid)
        paths.append(work / f"batch-{pid}.pt")
        torch.save({k: v.cpu() for k, v in batch.items()}, paths[-1])
    torch.cuda.synchronize()
    launches = dict(fused.LAUNCHES)
    check_launches("mesh elastic", engine.lowered_plan, {1: launches})
    del batch, engine
    batches = BatchFiles(paths)
    axes = ("data", "model")
    world = World(MESH_ELASTIC, axes, dev)
    lr = TRAIN_LR[0]

    def trainer(where, root: Path, dtype=torch.float32) -> ElasticTrainer:
        return ElasticTrainer(
            make_mesh=lambda: where,
            make_state=functools.partial(mesh_elastic_state, cfg=cfg, dtype=dtype),
            make_step=functools.partial(mesh_elastic_step, cfg=cfg, dtype=dtype),
            state_shardings=functools.partial(mesh_elastic_specs, cfg=cfg),
            ckpt=CheckpointManager(str(root), async_save=False), checkpoint_every=2)

    def fail(root: Path, dtype=torch.float32) -> None:
        try:
            trainer(world, root, dtype).run(batches, max_steps=ELASTIC_STEPS, fail_at=3)
            raise SmokeFailure("mesh elastic: the injected failure did not fire")
        except RuntimeError as exc:
            if "SimulatedFailure: simulated failure at step 3" not in str(exc):
                raise
        latest = CheckpointManager(str(root)).latest_step()
        check(latest == 2, f"mesh elastic: latest step {latest} after the failure, want 2")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info(dev)[0]
    failed = work / "failed"
    t0 = time.perf_counter()
    fail(failed)
    fail_s = time.perf_counter() - t0
    free_after = torch.cuda.mem_get_info(dev)[0]
    for _ in range(20):  # an exited process's memory may take a moment to return
        if free_after >= free_before - (64 << 20):
            break
        time.sleep(0.5)
        free_after = torch.cuda.mem_get_info(dev)[0]
    check(free_after >= free_before - (64 << 20), f"mesh elastic: {free_before} bytes free "
          f"before the failed world, {free_after} after it ended")

    # the meshed save against a one-device save of the same global state
    state = mesh_elastic_state(dev, cfg)
    CheckpointManager(str(failed)).restore(2, target=state)
    one = work / "one"
    ck_one = CheckpointManager(str(one), async_save=False)
    ck_one.save(2, state)
    meshed_sha = sha256_files(failed / "step_000000002")
    one_sha = sha256_files(one / "step_000000002")
    nbytes = ck_one.last_save["bytes"]
    check(meshed_sha == one_sha, "mesh elastic: the meshed save's files differ from a "
          f"one-device save of the same state: {sorted(k for k in one_sha if meshed_sha.get(k) != one_sha[k])}")
    shutil.rmtree(one)
    del state

    # resumes, from hard links of the failed run's files (no second write)
    resumed = {}
    for name, where in (("mesh", world), ("one device", dev)):
        root = work / f"resume {name}"
        shutil.copytree(failed, root, copy_function=os.link)
        t0 = time.perf_counter()
        tr = trainer(where, root)
        done, metrics = tr.run(batches, max_steps=ELASTIC_STEPS)
        resumed[name] = {"root": root, "s": time.perf_counter() - t0, "loss": metrics["loss"],
                         "state": tr.state}
        check(done == ELASTIC_STEPS, f"mesh elastic: the {name} resume ended at step {done}")
    shutil.rmtree(failed)

    # straight f32 runs on one device and on the mesh, the latter also
    # held against the mesh's resume (i)
    straight = mesh_elastic_straight(dev, cfg, batches)
    want = dict(straight["state"]["params"].named_parameters())
    got = dict(resumed["one device"].pop("state")["params"].named_parameters())
    one_worst, one_over = param_drift({k: (p, (slice(None),) * p.dim()) for k, p in got.items()},
                                      want, lr / 100)
    n_params = sum(p.numel() for p in want.values())
    loss_drift = abs(resumed["one device"]["loss"] - straight["loss"])
    del got
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = world.run(mesh_elastic_straight_rank,
                      args=(cfg, batches, str(resumed["mesh"]["root"])))
    straight_s = time.perf_counter() - t0
    mesh_worst = max(r["worst"] for r in ranks)
    rank_peak = max(r["peak"] for r in ranks)
    view = Mesh(dict(zip(axes, MESH_ELASTIC)), 0, dev, "")
    blocks = {}  # every distinct block of the mesh's final parameters
    for rank, r in enumerate(ranks):
        for k, p in r["params"].items():
            if rank == 0 or p.shape != want[k].shape:  # replicas once
                blocks[f"{k}@{rank}"] = (p, block_index(tuple(want[k].shape), view,
                                                        r["specs"][k], view.coords_of(rank)))
    mesh_drift = param_drift(blocks, {k: want[k.split("@")[0]] for k in blocks}, lr / 100)

    # the first step: ReLUs whose sign differs, the rows their samples
    # pool, and the table-gradient entries whose sign differs
    flips = [torch.nonzero(torch.from_numpy(a) != b)[:, 0]
             for a, b in zip(ranks[0]["signs"], straight["signs"])]
    n_relu = sum(int(f.numel()) for f in flips)
    samples = sorted(set(torch.cat(flips).tolist())) if flips else []
    touched = sample_rows(torch.load(paths[0]), samples, cfg.n_tables, cfg.data.embedding_rows)
    g_one = straight["grad0"]
    sign_rows = sign_in_touched = 0
    g_flipped = []
    for rank, r in enumerate(ranks):
        index = block_index(tuple(g_one.shape), view, r["specs"]["tables"], view.coords_of(rank))
        a, b = g_one[index], torch.from_numpy(r["grad0"]).to(dev)
        differ = torch.sign(a) != torch.sign(b)
        g_flipped.append(a[differ].abs())
        rows = differ.any(-1).cpu()
        sign_rows += int(rows.sum())
        sign_in_touched += int((rows & touched[index[:2]]).sum())
    g_flipped = torch.cat(g_flipped)
    g_lo = float(g_flipped.min()) if g_flipped.numel() else float("nan")
    g_med = float(g_flipped.median()) if g_flipped.numel() else float("nan")
    del straight, want, blocks, ranks
    gc.collect()
    torch.cuda.empty_cache()

    # the control: the same drill in f64, where the mesh's order of sums
    # flips no ReLU; the mesh's two steps and the one-device resume
    # against a straight one-device run
    f64 = work / "failed f64"
    t0 = time.perf_counter()
    fail(f64, torch.float64)
    at2 = CheckpointManager(str(f64)).restore(
        2, target=mesh_elastic_state(dev, cfg, torch.float64))
    tr = trainer(dev, f64, torch.float64)
    done, metrics64 = tr.run(batches, max_steps=ELASTIC_STEPS)
    check(done == ELASTIC_STEPS, f"mesh elastic: the f64 resume ended at step {done}")
    run64 = mesh_elastic_state(dev, cfg, torch.float64)
    step64 = mesh_elastic_step(dev, cfg, torch.float64)
    worst64 = {}
    for i, batch in batches:
        run64, m64 = step64(run64, batch)
        if i + 1 in (2, ELASTIC_STEPS):
            other = at2 if i + 1 == 2 else tr.state
            with torch.no_grad():
                worst64[i + 1] = max(float((a - b).abs().max()) for a, b in zip(
                    other["params"].parameters(), run64["params"].parameters()))
    loss64 = abs(metrics64["loss"] - float(m64["loss"]))
    f64_s = time.perf_counter() - t0
    del at2, tr, run64, step64
    gc.collect()
    torch.cuda.empty_cache()

    rule = 2 * lr * ELASTIC_STEPS  # the train rule's bound everywhere: 2 lr a step
    print(f"mesh elastic: {cfg.name} feature geometry, tables {cfg.n_tables} x "
          f"{MESH_ELASTIC_ROWS} x {cfg.emb_dim} ({nbytes}-byte checkpoints), ranks "
          f"{MESH_ELASTIC} sharing the card: the failed world ({fail_s:.1f} s with the "
          f"spawn) left step 2, {free_before} bytes free before its spawn and "
          f"{free_after} after it ended; its save equals a one-device save of the same "
          f"state, {len(one_sha)} files by sha256; resumed on {MESH_ELASTIC} in "
          f"{resumed['mesh']['s']:.1f} s (loss {resumed['mesh']['loss']:.5f}), largest "
          f"|resumed - straight on the mesh| {mesh_worst:.3g} (bound 1e-5; straight run "
          f"{straight_s:.1f} s, peak {rank_peak} bytes a rank); resumed on one device in {resumed['one device']['s']:.1f} s; "
          f"card {card}")
    print(f"mesh elastic f64 control: the mesh's 2 steps {worst64[2]:.3g} from one device's, "
          f"the one-device resume {worst64[ELASTIC_STEPS]:.3g} from a straight one-device run "
          f"(losses {loss64:.3g} apart; bound 1e-5), {f64_s:.1f} s")
    print(f"mesh elastic f32 across topologies (of {n_params} entries): the one-device resume "
          f"against a straight one-device run up to {one_worst:.3g}, {one_over} entries past "
          f"lr/100 (loss {loss_drift:.3g} apart); a straight run on {MESH_ELASTIC}, no restart, "
          f"up to {mesh_drift[0]:.3g}, {mesh_drift[1]} past lr/100 (bounds: {rule:.3g} "
          f"everywhere, past lr/100 at most the straight mesh run's entries and 1% more); the first "
          f"step: {n_relu} ReLU signs differ in {len(samples)} of {src.rows} samples, which "
          f"pool {int(touched.sum())} table rows; {sign_rows} rows have a gradient entry of "
          f"another sign, {sign_in_touched} of them among those rows; those entries' |g| "
          f"from {g_lo:.3g} (median {g_med:.3g}; AdamW eps 1e-8); "
          f"{time.perf_counter() - t_phase:.1f} s in all")
    check(mesh_worst <= 1e-5, f"mesh elastic: resumed on the mesh {mesh_worst} from straight")
    check(max(worst64.values()) <= 1e-5 and loss64 <= 1e-6,
          f"mesh elastic f64: {worst64} from one device's run, losses {loss64} apart")
    check(one_worst <= rule and one_over <= mesh_drift[1] + n_params // 100,
          f"mesh elastic: the one-device resume {one_worst} from a straight one-device run, "
          f"{one_over} entries past lr/100 (a straight mesh run: {mesh_drift[1]})")
    return {1: launches}


def lm_numpy_tree(cfg, seed: int, schema=None) -> dict:
    """Seeded numpy weights of the schema's shapes (the decoder-only
    model's unless given): normal times the schema's scale, and 0.1 times
    normal where the schema starts at zero (the norms, the SSM's ``A_log``,
    ``D`` and ``dt_bias``), so every weight moves the logits."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import ParamDef

    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, ParamDef):
            x = rng.standard_normal(node.shape, dtype=np.float32)
            if node.init != "normal":
                return x * np.float32(0.1)
            scale = node.scale if node.scale is not None else 1.0 / np.sqrt(max(node.fan_in(), 1))
            return x * np.float32(scale)
        return {k: walk(v) for k, v in node.items()}

    return walk(T.model_schema(cfg) if schema is None else schema)


def lm_greedy(params, prompts, cfg, steps: int):
    """Prefill and `steps` greedy decode steps: the prefill's last logits,
    each step's logits, and the tokens (B, steps + 1)."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import transformer as T
    from repro_torch.train import make_serve_step

    rules = ShardingRules.make(None)
    p = prompts.shape[1]
    logits, caches = T.prefill(params, prompts, cfg, rules, p + steps + 1)
    serve = make_serve_step(lambda pr, t, c, n: T.decode_step(pr, t, c, n, cfg, rules))
    token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    tokens, kept = [token], []
    for i in range(steps):
        token, lg, caches = serve(params, token, caches, p + i)
        tokens.append(token)
        kept.append(lg[:, -1].float())
    return logits[:, -1].float(), kept, torch.cat(tokens, dim=1)


def phase_lm_serve(dev) -> None:
    """The dense LM serving path (``models.transformer``, ``launch.serve``):

    (a) the reduced h2o-danube, gemma-7b and gemma3-12b in f32 from one
        seeded numpy tree (``params_from_numpy``): prefill logits and
        LM_PARITY_DECODE greedy decode steps on the card within
        rtol=atol=1e-4 of the port's own CPU run, the tokens equal;
    (b) the full h2o-danube-1.8b (random weights from LM_SEED, f32 params
        with one bf16 copy, ``cast_weights``): batch LM_BATCH, a prompt of
        LM_PROMPT tokens (past the 4,096 window, so swa masks whole kv
        blocks), LM_GEN tokens generated; prefill s, decode ms a step and
        tok/s (CUDA events), peak device bytes, and the byte floor of a
        decode step; the first and the last decode steps' logits held
        within LM_BF16_TOL of the prefill logits at their positions (a
        prefill of the prompt, the generated tokens and filler to
        LM_CHECK_LEN; attention is causal, so the logits at position t are
        those of a prefill of the first t + 1 tokens), and how far a first
        step planted one position late lands from them;
    (c) ``repro_torch.launch.serve`` with its defaults.

    None of the eight kernels is launched."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.kernels import fused
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.train import make_serve_step

    t_phase = time.perf_counter()
    card = card_line(CARD)
    fused.reset_launches()
    rng = np.random.default_rng(LM_SEED)

    # (a) reduced-width parity, the card against the CPU
    for arch in LM_PARITY_ARCHS:
        cfg = get_arch(arch).reduced
        tree = lm_numpy_tree(cfg, LM_SEED)
        prompts = rng.integers(1, cfg.vocab_size, (2, LM_PARITY_PROMPT)).astype(np.int32)
        runs = [lm_greedy(T.params_from_numpy(tree, cfg, d), torch.from_numpy(prompts).to(d),
                          cfg, LM_PARITY_DECODE) for d in (dev, torch.device("cpu"))]
        (gp, gl, gt), (cp, cl, ct) = runs
        pairs = list(zip([gp] + gl, [cp] + cl))
        errs = [float((g.cpu() - c).abs().max()) for g, c in pairs]
        check(all(torch.allclose(g.cpu(), c, rtol=1e-4, atol=1e-4) for g, c in pairs),
              f"lm (a) {arch}: logits {errs} from the CPU run's (rtol=atol=1e-4)")
        check(torch.equal(gt.cpu(), ct), f"lm (a) {arch}: greedy tokens differ from the CPU's")
        print(f"lm (a): {cfg.name} f32, prompt 2 x {LM_PARITY_PROMPT}, {LM_PARITY_DECODE} "
              f"decode steps: logits within {max(errs):.3g} of the CPU run (rtol=atol=1e-4), "
              f"greedy tokens equal")

    # (b) the full h2o-danube-1.8b in bf16
    cfg = get_arch(LM_ARCH).config
    rules = ShardingRules.make(None)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev)
    n_params = sum(t.numel() for t in lm_leaves(params))
    served = T.cast_weights(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = lm_leaves(served)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    embed = served["embed"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
                               .astype(np.int32)).to(dev)
    max_seq = LM_PROMPT + LM_GEN
    serve_step = make_serve_step(lambda p, t, c, n: T.decode_step(p, t, c, n, cfg, rules))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    logits, caches = T.prefill(served, prompts, cfg, rules, max_seq)
    b.record()
    b.synchronize()
    prefill_ms = a.elapsed_time(b)
    cache_bytes = sum(t.numel() * t.element_size() for c in caches.values() for t in c.values())
    token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    tokens, marks, kept, host_ms = [token], [], {}, []
    last = LM_GEN - 2
    for i in range(LM_GEN - 1):
        if i == 0:
            # the planted fault: the first token one position late (RoPE
            # and cache slot), attending an empty slot; the real step 1
            # overwrites the slot it writes
            _, lg, _ = serve_step(served, token, caches, LM_PROMPT + 1)
            planted = lg[:, -1].float().clone()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        h0 = time.perf_counter()
        token, lg, caches = serve_step(served, token, caches, LM_PROMPT + i)
        host_ms.append((time.perf_counter() - h0) * 1e3)  # the host's enqueue of the step
        b.record()
        marks.append((a, b))
        tokens.append(token)
        if i in (0, last):
            kept[i] = lg[:, -1].float().clone()
    torch.cuda.synchronize()
    step_ms = [x.elapsed_time(y) for x, y in marks]
    # one more step (the cache's last slot) under the profiler: device busy
    dec_busy, dec_launches, dec_top = lm_profile(
        lambda: serve_step(served, token, caches, max_seq - 1))
    decode_ms = marks[0][0].elapsed_time(marks[-1][1])
    tok_s = LM_BATCH * (LM_GEN - 1) / (decode_ms / 1e3)
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(tokens, dim=1)
    check(gen.shape == (LM_BATCH, LM_GEN) and int(gen.min()) >= 0
          and int(gen.max()) < cfg.vocab_size, f"lm (b): generated {tuple(gen.shape)} ids "
          f"in [{int(gen.min())}, {int(gen.max())}]")
    check(all(bool(torch.isfinite(v).all()) for v in kept.values()), "lm (b): logits not finite")
    del caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    # the byte floor of a decode step: every weight but the embedding table
    # (its B rows instead) read once, the step's k and v written, and the
    # cache read once, whole as allocated or only the window the step attends
    row = embed.shape[1] * embed.element_size()
    step_weights = weight_bytes - embed.numel() * embed.element_size() + LM_BATCH * row
    kv = 2 * LM_BATCH * cfg.n_kv_heads * cfg.hd * 2  # k and v of one position, one layer, bf16
    window = min(LM_PROMPT + last + 1, cfg.window) * kv * cfg.n_layers
    floor_whole = (step_weights + cache_bytes) / PEAK_BYTES_PER_S * 1e3
    floor_window = (step_weights + window + kv * cfg.n_layers) / PEAK_BYTES_PER_S * 1e3

    # decode held against prefill at the first and last decode steps
    filler = torch.from_numpy(rng.integers(1, cfg.vocab_size, (
        LM_BATCH, LM_CHECK_LEN - LM_PROMPT - LM_GEN)).astype(np.int32)).to(dev)
    seq = torch.cat([prompts, gen, filler], dim=1)
    t1 = time.perf_counter()
    h, ck = T.prefill_hidden(served, seq, cfg, rules, LM_CHECK_LEN)
    del ck
    at = T._logits_head(served, h[:, [LM_PROMPT, LM_PROMPT + last]], cfg, rules).float()
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t1
    del h
    errs, agree = [], []
    for j, i in enumerate((0, last)):
        ref = at[:, j]
        errs.append(float((kept[i] - ref).abs().max()))
        top2 = torch.topk(ref, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LM_BF16_TOL
        agree.append(bool(torch.equal(gen[:, i + 1][clear], ref.argmax(-1).to(torch.int32)[clear])))
    scale = float(at.abs().max())
    planted_err = float((planted - at[:, 0]).abs().max())
    print(f"lm (b): {cfg.name} full width ({n_params} parameters, f32 params with one bf16 "
          f"copy of {weight_bytes} bytes, built in {init_s:.1f} s), batch {LM_BATCH}, prompt "
          f"{LM_PROMPT}, {LM_GEN} tokens generated: prefill {prefill_ms / 1e3:.4f} s, decode "
          f"{LM_GEN - 1} steps {decode_ms:.3f} ms ({decode_ms / (LM_GEN - 1):.4f} ms a step; "
          f"first {step_ms[0]:.4f}, median {statistics.median(step_ms):.4f}, last "
          f"{step_ms[-1]:.4f}; {tok_s:.1f} tok/s; CUDA events); KV cache {cache_bytes} bytes; "
          f"peak {peak} bytes ({base} of weights before the prefill); decode-step byte floor "
          f"{floor_whole:.4f} ms reading the whole cache ({step_weights} weight bytes + "
          f"{cache_bytes}), {floor_window:.4f} ms reading the window the last step attends "
          f"({window} bytes) at {PEAK_BYTES_PER_S / 1e12} TB/s; decode against a prefill of "
          f"{LM_CHECK_LEN} tokens at positions {LM_PROMPT} and {LM_PROMPT + last}: max |diff| "
          f"{errs[0]:.4g} and {errs[1]:.4g} (bound {LM_BF16_TOL}; logits up to {scale:.4g}; "
          f"a first step planted one position late {planted_err:.4g}), greedy tokens agree "
          f"where the margin passes the bound: {agree} ({check_s:.1f} s); "
          f"card {card}")
    med = statistics.median(step_ms)
    print(f"lm (b) device time (torch.profiler): a decode step {dec_busy:.4f} ms busy in "
          f"{dec_launches} launches against the median step's {med:.4f} ms (CUDA events), idle "
          f"{1 - dec_busy / med:.1%}; the host enqueues a step in {statistics.median(host_ms):.4f} "
          f"ms (median; host clock); top {dec_top}")
    check(max(errs) <= LM_BF16_TOL, f"lm (b): decode logits {errs} from the prefill's")
    check(all(agree), "lm (b): a greedy token differs from the prefill's argmax")
    del served, embed, leaves, seq, gen, prompts, at, planted
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the CLI with its defaults
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = serve.main([])
    lines = buf.getvalue().splitlines()
    print("lm (c): python -m repro_torch.launch.serve: " + " | ".join(lines))
    check(len(lines) == 2 and lines[0].startswith(f"{LM_ARCH}: prefill(4x64)")
          and lines[1].startswith("sample token ids:") and out["tokens"].shape == (4, 32),
          f"lm (c): {lines}")
    launched = {k: v for k, v in fused.LAUNCHES.items() if v}
    check(not launched, f"lm: the LM path launched {launched}")
    print(f"lm: none of the eight kernels launched; {time.perf_counter() - t_phase:.1f} s "
          f"in all; card {card}")


def encdec_greedy(params, frames, cfg, steps: int):
    """``encode``, the cross caches and `steps` greedy decode steps from
    token 1: the encoder output, each step's logits, and the tokens
    (B, steps + 1)."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import encdec as E
    from repro_torch.train import make_serve_step

    rules = ShardingRules.make(None)
    enc = E.encode(params, frames, cfg, rules)
    caches = E.cross_caches(params, enc, cfg, steps)
    serve = make_serve_step(lambda pr, t, c, n: E.decode_step(pr, t, c, n, cfg, rules))
    token = torch.ones((frames.shape[0], 1), dtype=torch.int32, device=frames.device)
    tokens, kept = [token], []
    for i in range(steps):
        token, lg, caches = serve(params, token, caches, i)
        tokens.append(token)
        kept.append(lg[:, -1].float())
    return enc.float(), kept, torch.cat(tokens, dim=1)


@contextlib.contextmanager
def moe_drops():
    """Counts what the MoE's capacity drops while the block runs: a list
    with one (G, tb) tensor per routed block, each token's choices that
    were dropped (the routing wrapped, its results unchanged)."""
    from repro_torch.models import moe

    route, counts = moe._route_block, []

    def counted(xb, router, k, capacity, *rest):
        dispatch, gates, aux = route(xb, router, k, capacity, *rest)
        counts.append(k - dispatch.sum(dim=(2, 3)))
        return dispatch, gates, aux

    moe._route_block = counted
    try:
        yield counts
    finally:
        moe._route_block = route


def total_drops(counts: list) -> int:
    return int(round(sum(float(c.sum()) for c in counts)))


def drops_at(counts: list, s: int, positions: list) -> int:
    """Dropped choices at `positions` of a prefill of `s` tokens, over
    every MoE layer (the blocks of one layer run in order, layer after
    layer)."""
    if not counts:
        return 0
    by_pos = torch.cat(counts, dim=1).reshape(counts[0].shape[0], -1, s).sum(dim=1)
    return int(round(float(by_pos[:, positions].sum())))


def lm_decode_run(dev, served, prompts, serve_step, prefill):
    """`prefill(prompts)`, then LM_GEN - 1 greedy decode steps, each timed
    by CUDA events; one more step under the profiler.  Returns a dict of
    the times, the tokens, the logits of the first and last steps, the
    profile, the peak bytes and the cache's bytes."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    logits, caches, start = prefill(prompts)
    b.record()
    b.synchronize()
    out = {"prefill_ms": a.elapsed_time(b),
           "cache_bytes": sum(t.numel() * t.element_size() for t in lm_leaves(caches))}
    token = (torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
             if logits is not None else
             torch.ones((prompts.shape[0], 1), dtype=torch.int32, device=dev))
    steps = LM_GEN - 1 if logits is not None else LM_GEN
    tokens, marks, kept, host_ms = [token], [], {}, []
    for i in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        h0 = time.perf_counter()
        token, lg, caches = serve_step(served, token, caches, start + i)
        host_ms.append((time.perf_counter() - h0) * 1e3)
        b.record()
        marks.append((a, b))
        tokens.append(token)
        if i in (0, steps - 1):
            kept[i] = lg[:, -1].float().clone()
    torch.cuda.synchronize()
    out["step_ms"] = [x.elapsed_time(y) for x, y in marks]
    out["decode_ms"] = marks[0][0].elapsed_time(marks[-1][1])
    out["busy"], out["launches"], out["top"] = lm_profile(
        lambda: serve_step(served, token, caches, start + steps))
    out["peak"] = torch.cuda.max_memory_allocated()
    out["host_ms"] = statistics.median(host_ms)
    out["tokens"], out["kept"], out["steps"] = torch.cat(tokens, dim=1), kept, steps
    del caches
    return out


def lm_times(r: dict, batch: int) -> str:
    med = statistics.median(r["step_ms"])
    tok_s = batch * r["steps"] / (r["decode_ms"] / 1e3)
    return (f"decode {r['steps']} steps {r['decode_ms']:.3f} ms ({r['decode_ms'] / r['steps']:.4f} "
            f"ms a step; first {r['step_ms'][0]:.4f}, median {med:.4f}, last "
            f"{r['step_ms'][-1]:.4f}; {tok_s:.1f} tok/s; CUDA events); peak {r['peak']} bytes; "
            f"a decode step {r['busy']:.4f} ms busy in {r['launches']} launches "
            f"(torch.profiler), idle {1 - r['busy'] / med:.1%} of the median step; the host "
            f"enqueues a step in {r['host_ms']:.4f} ms (median; host clock); top {r['top']}")


def lm_full(dev, arch: str, overrides: dict, rng, card: str) -> None:
    """(e)/(f): a decoder-only arch at full width in bf16, batch LM_BATCH,
    a prompt of LM_PROMPT and LM_GEN generated; decode held against a
    prefill of LM_CHECK_LEN tokens at the first and last decode steps."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import transformer as T
    from repro_torch.train import make_serve_step

    cfg = dataclasses.replace(get_arch(arch).config, **overrides)
    tol = LM_FULL_TOL[arch]
    rules = ShardingRules.make(None)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev)
    n_params = sum(t.numel() for t in lm_leaves(params))
    served = T.cast_weights(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in lm_leaves(served))
    expert_bytes = sum(t.numel() * t.element_size() for p in served["layers"].values()
                       if "router" in p.get("mlp", {}) for k, t in p["mlp"].items()
                       if k != "router")
    embed = served["embed"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
                               .astype(np.int32)).to(dev)
    max_seq = LM_PROMPT + LM_GEN
    serve_step = make_serve_step(lambda p, t, c, n: T.decode_step(p, t, c, n, cfg, rules))
    with moe_drops() as counts:
        blocks = []

        def prefill(x):
            logits, caches = T.prefill(served, x, cfg, rules, max_seq)
            blocks.append(len(counts))
            return logits, caches, LM_PROMPT

        r = lm_decode_run(dev, served, prompts, serve_step, prefill)
        prefill_drops = total_drops(counts[:blocks[0]])
        decode_drops = total_drops(counts[blocks[0]:])
    gen, kept, last = r["tokens"], r["kept"], r["steps"] - 1
    check(gen.shape == (LM_BATCH, LM_GEN) and int(gen.min()) >= 0
          and int(gen.max()) < cfg.vocab_size, f"lm {arch}: generated {tuple(gen.shape)} ids "
          f"in [{int(gen.min())}, {int(gen.max())}]")
    check(all(bool(torch.isfinite(v).all()) for v in kept.values()), f"lm {arch}: logits "
          f"not finite")
    gc.collect()
    torch.cuda.empty_cache()
    # the byte floor of a decode step: every weight but the embedding table
    # (its B rows instead) read once, every cache entry read once and the
    # step's writes (attention: k and v of one position; mamba: h and conv
    # rewritten whole)
    row = embed.shape[1] * embed.element_size()
    step_weights = weight_bytes - embed.numel() * embed.element_size() + LM_BATCH * row
    spec = T.cache_spec(cfg, LM_BATCH, max_seq)
    cache_io = 0
    for c in spec.values():
        for name, t in c.items():
            nb = math.prod(t.shape) * t.dtype.itemsize
            cache_io += nb + (nb // max_seq if name in ("k", "v") else nb)
    floor = (step_weights + cache_io) / PEAK_BYTES_PER_S * 1e3
    sparse = ""
    if expert_bytes:
        share = min(cfg.n_experts, LM_BATCH * cfg.top_k) / cfg.n_experts
        floor_sparse = (step_weights - expert_bytes * (1 - share) + cache_io) / PEAK_BYTES_PER_S * 1e3
        sparse = (f"; the dense MoE reads all {expert_bytes} expert bytes a step, a top-"
                  f"{cfg.top_k} dispatch of {LM_BATCH} tokens at most {share:.4g} of them: floor "
                  f"{floor_sparse:.4f} ms")

    # decode held against prefill at the first and last decode steps
    filler = torch.from_numpy(rng.integers(1, cfg.vocab_size, (
        LM_BATCH, LM_CHECK_LEN - LM_PROMPT - LM_GEN)).astype(np.int32)).to(dev)
    seq = torch.cat([prompts, gen, filler], dim=1)
    t1 = time.perf_counter()
    checked = [LM_PROMPT, LM_PROMPT + last]
    with moe_drops() as counts:
        h, ck = T.prefill_hidden(served, seq, cfg, rules, LM_CHECK_LEN)
        check_drops, checked_drops = total_drops(counts), drops_at(counts, LM_CHECK_LEN, checked)
    del ck
    at = T._logits_head(served, h[:, checked], cfg, rules).float()
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t1
    del h
    errs, agree = [], []
    for j, i in enumerate((0, last)):
        ref = at[:, j]
        errs.append(float((kept[i] - ref).abs().max()))
        top2 = torch.topk(ref, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol
        agree.append(bool(torch.equal(gen[:, i + 1][clear], ref.argmax(-1).to(torch.int32)[clear])))
    scale = float(at[..., :cfg.vocab_size].abs().max())  # the padded rows are -1e30
    kinds = sorted({(s.kind, s.mlp_kind if cfg.d_ff else None) for s in cfg.period()},
                   key=str)
    print(f"lm {arch}: full width ({cfg.n_layers} layers of {kinds}; {n_params} parameters in "
          f"{cfg.param_dtype}, {weight_bytes} bytes served in {cfg.dtype}, built in "
          f"{init_s:.1f} s), batch {LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} tokens generated: "
          f"prefill {r['prefill_ms'] / 1e3:.4f} s; {lm_times(r, LM_BATCH)}; caches "
          f"{r['cache_bytes']} bytes; {base} bytes of weights before the prefill; decode-step "
          f"byte floor {floor:.4f} ms ({step_weights} weight bytes + {cache_io} cache bytes at "
          f"{PEAK_BYTES_PER_S / 1e12} TB/s){sparse}; card {card}")
    print(f"lm {arch}: decode against a prefill of {LM_CHECK_LEN} tokens at positions "
          f"{LM_PROMPT} and {LM_PROMPT + last}: max |diff| {errs[0]:.4g} and {errs[1]:.4g} "
          f"(bound {tol}; logits up to {scale:.4g}), greedy tokens agree where the margin "
          f"passes the bound: {agree}; expert choices dropped by the MoE's capacity (of "
          f"{cfg.top_k} a token and MoE layer): the served prefill {prefill_drops}, decode "
          f"{decode_drops}, the check's prefill {check_drops}, {checked_drops} of them at the "
          f"checked positions ({check_s:.1f} s)")
    check(decode_drops == 0, f"lm {arch}: a decode step dropped {decode_drops} choices")
    check(checked_drops == 0, f"lm {arch}: the check's prefill dropped {checked_drops} "
          f"choices at the checked positions, where decode drops none")
    check(max(errs) <= tol, f"lm {arch}: decode logits {errs} from the prefill's")
    check(all(agree), f"lm {arch}: a greedy token differs from the prefill's argmax")
    del served, embed, seq, gen, prompts, at, r, kept
    gc.collect()
    torch.cuda.empty_cache()


def lm_encdec_full(dev, rng, card: str) -> None:
    """(g): the full seamless-m4t-medium: held in f32 on the card against
    the CPU at ENCDEC_CHECK, then served in bf16 (f32 params with one bf16
    copy): LM_BATCH x ENCDEC_FRAMES frames encoded, the cross caches built,
    LM_GEN tokens decoded."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T
    from repro_torch.train import make_serve_step

    cfg = get_arch(ENCDEC_ARCH).config
    rules = ShardingRules.make(None)
    gc.collect()
    torch.cuda.empty_cache()
    params = E.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev)
    n_params = sum(t.numel() for t in lm_leaves(params))

    # f32, the card against the CPU, from the same weights
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    frames_n, steps = ENCDEC_CHECK
    small = torch.from_numpy(rng.normal(size=(2, frames_n, cfg.d_model)).astype(np.float32))
    t0 = time.perf_counter()
    host = _tree_to(params, torch.device("cpu"))
    (ge, gl, gt), (ce, cl, ct) = (encdec_greedy(p, small.to(p["head"].device), cfg32, steps)
                                  for p in (params, host))
    del host
    pairs = [(ge, ce)] + list(zip(gl, cl))
    errs = [float((g.cpu() - c).abs().max()) for g, c in pairs]
    check(all(torch.allclose(g.cpu(), c, rtol=ENCDEC_F32_TOL, atol=ENCDEC_F32_TOL)
              for g, c in pairs), f"lm (g) f32: encode and logits {errs} from the CPU run's")
    check(torch.equal(gt.cpu(), ct), "lm (g) f32: greedy tokens differ from the CPU's")
    print(f"lm (g): {cfg.name} full width in f32, 2 x {frames_n} frames, {steps} decode steps: "
          f"encode within {errs[0]:.3g} and logits within {max(errs[1:]):.3g} of the CPU run "
          f"(rtol=atol={ENCDEC_F32_TOL}), greedy tokens equal ({time.perf_counter() - t0:.1f} s)")

    served = T.cast_weights(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    weight_bytes = sum(t.numel() * t.element_size() for t in lm_leaves(served))
    dec_bytes = sum(t.numel() * t.element_size() for t in lm_leaves(served["dec_layers"]))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    frames = torch.from_numpy(rng.normal(size=(LM_BATCH, ENCDEC_FRAMES, cfg.d_model))
                              .astype(np.float32)).to(dev)
    serve_step = make_serve_step(lambda p, t, c, n: E.decode_step(p, t, c, n, cfg, rules))
    marks = {}

    def encode(x):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        enc = E.encode(served, x, cfg, rules)
        b.record()
        caches = E.cross_caches(served, enc, cfg, LM_GEN + 1)
        c = torch.cuda.Event(enable_timing=True)
        c.record()
        marks["enc"], marks["cross"] = (a, b), (b, c)
        check(bool(torch.isfinite(enc).all()), "lm (g): the encoder output is not finite")
        return None, caches, 0

    r = lm_decode_run(dev, served, frames, serve_step, encode)
    enc_ms = marks["enc"][0].elapsed_time(marks["enc"][1])
    cross_ms = marks["cross"][0].elapsed_time(marks["cross"][1])
    gen = r["tokens"]
    check(gen.shape == (LM_BATCH, LM_GEN + 1) and int(gen.max()) < cfg.vocab_size
          and all(bool(torch.isfinite(v).all()) for v in r["kept"].values()),
          f"lm (g): generated {tuple(gen.shape)} ids up to {int(gen.max())}")
    # the byte floor of a decode step: the decoder's weights, the head and
    # final norm, B rows of the embedding, the self caches and the cross
    # caches read once, the step's self k and v written
    embed = served["embed"]
    kv = 2 * LM_BATCH * cfg.n_kv_heads * cfg.hd * 2  # k and v of one position, one layer, bf16
    head_bytes = served["head"].numel() * served["head"].element_size()
    step_bytes = (dec_bytes + head_bytes + LM_BATCH * embed.shape[1] * embed.element_size()
                  + r["cache_bytes"] + kv * cfg.n_layers)
    floor = step_bytes / PEAK_BYTES_PER_S * 1e3
    print(f"lm (g): {cfg.name} full width ({cfg.enc_layers} + {cfg.n_layers} layers, "
          f"{n_params} parameters, f32 params with one bf16 copy of {weight_bytes} bytes), "
          f"batch {LM_BATCH}, {ENCDEC_FRAMES} frames, {LM_GEN} tokens decoded: encode "
          f"{enc_ms / 1e3:.4f} s, cross caches {cross_ms:.3f} ms (CUDA events); "
          f"{lm_times(r, LM_BATCH)}; caches {r['cache_bytes']} bytes; {base} bytes of weights "
          f"before the encode; decode-step byte floor {floor:.4f} ms ({step_bytes} bytes at "
          f"{PEAK_BYTES_PER_S / 1e12} TB/s); card {card}")
    del served, frames, r, gen, embed
    gc.collect()
    torch.cuda.empty_cache()


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def phase_lm_families(dev) -> None:
    """The rest of LM serving (``models.ssm``, ``models.moe``,
    ``models.encdec``, ``examples.serve_lm``):

    (d) the reduced mamba2, jamba, grok-1, llama4 and seamless in f32 from
        one seeded numpy tree: prefill logits (seamless: the encoder
        output) and LM_PARITY_DECODE greedy decode steps on the card within
        rtol=atol=1e-4 of the port's own CPU run, the tokens equal;
    (e), (f) the full mamba2-1.3b and one period of jamba-v0.1-52b (LM_FULL)
        in bf16: prefill s, decode ms a step and tok/s (CUDA events), peak
        bytes, a decode step's launches, busy ms and idle share
        (torch.profiler), its byte floor (jamba: also what a top-2 dispatch
        would read); the first and last decode steps held within
        LM_FULL_TOL of a prefill's logits at their positions, no token
        dropped by the MoE's capacity in any of the runs;
    (g) the full seamless-m4t-medium: in f32 on the card against the CPU,
        then encode, cross caches and decode in bf16 with the same numbers;
    and ``repro_torch.examples.serve_lm`` with its defaults (jamba, reduced).

    None of the eight kernels is launched."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.configs.registry import get_arch
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import fused
    from repro_torch.models import encdec as E
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    card = card_line(CARD)
    fused.reset_launches()
    rng = np.random.default_rng(LM_SEED + 1)

    # (d) reduced-width parity, the card against the CPU
    for arch in LM_FAMILY_PARITY:
        cfg = get_arch(arch).reduced
        if cfg.is_encdec:
            tree = lm_numpy_tree(cfg, LM_SEED, E.model_schema(cfg))
            frames = rng.normal(size=(2, LM_PARITY_PROMPT, cfg.d_model)).astype(np.float32)
            runs = [encdec_greedy(E.params_from_numpy(tree, cfg, d),
                                  torch.from_numpy(frames).to(d), cfg, LM_PARITY_DECODE)
                    for d in (dev, torch.device("cpu"))]
        else:
            tree = lm_numpy_tree(cfg, LM_SEED)
            prompts = rng.integers(1, cfg.vocab_size, (2, LM_PARITY_PROMPT)).astype(np.int32)
            runs = [lm_greedy(T.params_from_numpy(tree, cfg, d), torch.from_numpy(prompts).to(d),
                              cfg, LM_PARITY_DECODE) for d in (dev, torch.device("cpu"))]
        (gp, gl, gt), (cp, cl, ct) = runs
        pairs = [(gp, cp)] + list(zip(gl, cl))
        errs = [float((g.cpu() - c).abs().max()) for g, c in pairs]
        check(all(torch.allclose(g.cpu(), c, rtol=1e-4, atol=1e-4) for g, c in pairs),
              f"lm (d) {arch}: {errs} from the CPU run's (rtol=atol=1e-4)")
        check(torch.equal(gt.cpu(), ct), f"lm (d) {arch}: greedy tokens differ from the CPU's")
        first = "encoder output" if cfg.is_encdec else "prefill logits"
        print(f"lm (d): {cfg.name} f32, 2 x {LM_PARITY_PROMPT}, {LM_PARITY_DECODE} decode steps: "
              f"{first} within {errs[0]:.3g} and decode logits within {max(errs[1:]):.3g} of "
              f"the CPU run (rtol=atol=1e-4), greedy tokens equal")

    # (e), (f) full width, bf16
    for arch, overrides in LM_FULL:
        lm_full(dev, arch, overrides, rng, card)

    # (g) the encoder-decoder
    lm_encdec_full(dev, rng, card)

    # the example with its defaults
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = serve_lm.main([])
    lines = buf.getvalue().splitlines()
    print("lm: python -m repro_torch.examples.serve_lm: " + " | ".join(lines))
    check(len(lines) == 2 and lines[0] == "jamba-smoke: prefilled 4x48; decoding..."
          and lines[1].startswith("decoded 23 steps x 4 requests") and
          out["tokens"].shape == (4, 24), f"lm serve_lm: {lines}")
    launched = {k: v for k, v in fused.LAUNCHES.items() if v}
    check(not launched, f"lm: the LM families launched {launched}")
    print(f"lm families: none of the eight kernels launched; {time.perf_counter() - t_phase:.1f} "
          f"s in all; card {card}")


def lm_train_inputs(cfg, batch: int, seq: int, dev, step: int = 0) -> dict:
    """The LM driver's batch of `step` (``launch.train.lm_batch``: one
    TokenSynthesizer batch, frames or prefix embeddings drawn by a
    generator seeded with LM_SEED + step on the CPU), on `dev`."""
    from repro_torch.data.tokens import TokenSynthesizer
    from repro_torch.launch.train import lm_batch

    cpu = torch.device("cpu")
    host = lm_batch(TokenSynthesizer(cfg.vocab_size, seq, seed=LM_SEED), cfg, step, batch, seq,
                    cpu, torch.Generator(cpu).manual_seed(LM_SEED + step))
    return {k: v.to(dev) for k, v in host.items()}


def token_entropy(vocab: int) -> float:
    """The unigram entropy (nats) of TokenSynthesizer's stream: token k + 1
    for k = floor(u^3 (V - 2)), u uniform, so P(k) = ((k + 1) / (V - 2))^(1/3)
    - (k / (V - 2))^(1/3).  The tokens are drawn independently, so no model's
    expected xent on a batch it has not seen is below it; one that sees
    its labels (a causal leak) goes far below."""
    p = np.diff(np.cbrt(np.arange(vocab - 1, dtype=np.float64) / (vocab - 2)))
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def matmul_params(cfg, model) -> tuple:
    """(parameters a token multiplies in the decoder (or the whole
    decoder-only model), in the encoder): every parameter but the
    embedding table (a gather) and the norms, the MoE's experts at
    top_k / n_experts (what a token's routing needs)."""
    enc = dec = 0
    for name, p in model.named_parameters():
        if name == "embed" or p.dim() - ("layers" in name) < 2:
            continue
        n = p.numel()
        if ".mlp." in name and p.dim() == 4:  # (periods, E, d, f): an expert stack
            n = n * cfg.top_k // cfg.n_experts
        if name.startswith("enc_layers"):
            enc += n
        else:
            dec += n
    return dec, enc


def attn_flops(cfg, batch: int, seq: int, enc_seq: int = 0, visited: bool = True) -> int:
    """The attention FLOPs of a train step (forward and backward, 3 x the
    forward's QK^T and PV, 4 * hd a query-key pair and head).  `visited`:
    the pairs this implementation computes (blockwise_attention visits
    every block pair, masked ones too: Sq * Skv a layer); else the pairs
    the function needs (a self-attention's causal pairs within the window;
    the encoder's and the cross-attention's all)."""
    per = 3 * 4 * batch * cfg.n_heads * cfg.hd
    w = cfg.window if cfg.attention == "swa" and cfg.window else seq
    self_pairs = seq * seq if visited else sum(min(i + 1, w) for i in range(seq))
    if cfg.is_encdec:
        return per * (cfg.enc_layers * enc_seq * enc_seq
                      + cfg.n_layers * (self_pairs + seq * enc_seq))
    n_attn = cfg.n_periods * sum(s.kind == "attn" for s in cfg.period())
    return per * n_attn * self_pairs


def timed_optimizer(opt, marks: list):
    """`opt` with CUDA events around each update, appended to `marks`."""
    from repro_torch.train import Optimizer

    def update(grads, state, params, sq_sum=None, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = opt.update(grads, state, params, sq_sum, **kw)
        b.record()
        marks.append((a, b))
        return out

    return Optimizer(opt.init, update)


def plain_adafactor(g, st: dict, p, scale, lr, beta, eps: float = 1e-30):
    """The reference's Adafactor update of one leaf (``upd`` in
    ``repro.train.optimizer.adafactor``), in one pass over the whole leaf
    and out of place: (the new parameter, the new state)."""
    g32 = (g * scale.to(g.dtype)).to(torch.float32)
    g2 = g32 * g32 + eps
    if "vr" in st:
        vr = beta * st["vr"] + (1 - beta) * g2.mean(dim=-1)
        vc = beta * st["vc"] + (1 - beta) * g2.mean(dim=-2)
        del g2
        denom = (vr[..., None] * vc[..., None, :]
                 / torch.clamp_min(vr.mean(dim=-1)[..., None, None], eps))
        pre, new = g32 * torch.rsqrt(denom + eps), {"vr": vr, "vc": vc}
        del denom
    else:
        v = beta * st["v"] + (1 - beta) * g2
        pre, new = g32 * torch.rsqrt(v + eps), {"v": v}
    del g32
    pre = pre / torch.clamp_min(torch.sqrt(torch.mean(pre * pre) + 1e-12), 1.0)
    return p + (-lr * pre).to(p.dtype), new


def witnessed_adafactor(opt, lr_fn, steps: set, max_elems: int, out: list):
    """`opt` (the port's Adafactor) with its updates at the indices `steps`
    held against ``plain_adafactor`` on the same gradients, state and
    parameters, every leaf of at most `max_elems` elements; the chunked
    passes run where a leaf passes CHUNK_ELEMS.  Both take the clip's scale
    from the port's norm, which is held apart against a plain one.  Each
    witnessed update appends its errors to `out`."""
    from repro_torch.train import Optimizer

    calls = [0]

    def update(grads, state, params, sq_sum=None):
        i = calls[0]
        calls[0] += 1
        if i not in steps:
            return opt.update(grads, state, params, sq_sum)
        names = [n for n, p in params.items() if p.numel() <= max_elems]
        with torch.no_grad():
            gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                                for g in grads.values()))
            snap = {n: (grads[n].clone(), {k: v.clone() for k, v in state["f"][n].items()},
                        params[n].clone()) for n in names}
        count = int(state["count"]) + 1
        state, metrics = opt.update(grads, state, params, sq_sum)
        with torch.no_grad():
            port_gn = metrics["grad_norm"]
            scale = torch.clamp(1.0 / torch.clamp_min(port_gn, 1e-9), max=1.0)
            lr = float(lr_fn(count))
            beta = 1.0 - torch.tensor(float(count)) ** -0.8
            r = {"update": count, "leaves": len(names), "of": len(params),
                 "norm": float(abs(port_gn - gn) / gn), "param": 0.0, "state": 0.0,
                 "largest": 0.0, "ok": True}
            for n in names:
                g, st, p0 = snap.pop(n)
                want, want_st = plain_adafactor(g, st, p0, scale, lr, beta.to(g.device))
                got, want, p0 = params[n].float(), want.float(), p0.float()
                if params[n].dtype == torch.bfloat16:  # the update's rounding and the sum's
                    bound = (want.abs() + (want - p0).abs()).mul_(2 ** -7).clamp_min_(1e-30)
                else:
                    bound = want.abs().mul_(2 ** -22).add_(1e-4 * lr)
                err = (got - want).abs_()
                r["param"] = max(r["param"], float(err.div_(bound).max()))
                r["largest"] = max(r["largest"], float((got - p0).abs_().max()) / lr)
                for k, v in want_st.items():
                    have = state["f"][n][k]
                    r["state"] = max(r["state"], float(((have - v).abs()
                                                        / v.abs().clamp_min(1e-30)).max()))
                    r["ok"] &= torch.allclose(have, v, rtol=1e-5, atol=1e-30)
                del g, st, p0, want, want_st, got, bound, err
            r["ok"] &= r["norm"] <= 1e-5 and r["param"] <= 1
        out.append(r)
        return state, metrics

    return Optimizer(opt.init, update)


def witness_line(tag: str, w: list) -> str:
    return (f"lm train ({tag}) witness: {len(w)} updates ({[r['update'] for r in w]}), each of "
            f"{w[0]['leaves']} of {w[0]['of']} leaves against plain_adafactor (the reference's "
            f"arithmetic in one pass over the leaf) on the same gradients, state and parameters: "
            f"parameters within {max(r['param'] for r in w):.3g} of their bound (1 passes: "
            f"2^-22 |p| + 1e-4 lr in f32; in bf16 2^-7 (|p| + |the update|), a rounding of "
            f"each), state within "
            f"{max(r['state'] for r in w):.3g} relative (bound 1e-5), the clip's norm within "
            f"{max(r['norm'] for r in w):.3g} of a plain one (bound 1e-5); the largest "
            f"element update by update {[round(r['largest'], 1) for r in w]} lr (the clip "
            f"bounds the RMS alone)")


def lm_train_run(model, loss_fn, opt, batch: dict, steps: int, microbatches: int = 1,
                 profile_at: int | None = 1, heldout: dict | None = None,
                 wrap=None, after_step=None) -> dict:
    """`steps` train steps of `model` on one batch: each step's metrics,
    the first step's time and the later ones' (CUDA events; the step
    `profile_at`, if any, runs under ``torch.profiler`` instead and gives
    the busy ms, launches and top kernels, and its own time by events),
    each update's ms, the peak device bytes with the state built, and the
    xent on `heldout` after the last step.  `wrap`, if given, wraps the
    timed optimizer (a witness, outside the update's time); `after_step`,
    if given, is called with each step's index and metrics once the step
    has run.  The state is freed before it returns; the model keeps the
    trained parameters."""
    from repro_torch.train import init_state, make_train_step

    opt_marks, marks, metrics = [], [], []
    topt = timed_optimizer(opt, opt_marks)
    topt = wrap(topt) if wrap else topt
    step = make_train_step(loss_fn, topt, microbatches=microbatches)
    state = init_state(model, topt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = None
    for i in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        box = {}

        def run():
            a.record()
            box["out"] = step(state, batch)
            b.record()

        if i == profile_at:
            prof = (*lm_profile(run), (a, b))
        else:
            run()
            marks.append((a, b))
        state, m = box.pop("out")
        metrics.append({k: float(v) for k, v in m.items()})
        if after_step is not None:
            after_step(i, metrics[-1])
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in marks]
    out = {"metrics": metrics, "losses": [m["loss"] for m in metrics],
           "first_ms": times[0], "step_ms": times[1:],
           "opt_ms": [a.elapsed_time(b) for a, b in opt_marks],
           "peak": torch.cuda.max_memory_allocated(),
           "prof": prof and (*prof[:3], prof[3][0].elapsed_time(prof[3][1])),
           "grads_finite": all(bool(torch.isfinite(p.grad).all())
                               for p in model.parameters() if p.grad is not None)}
    model.zero_grad(set_to_none=True)
    del state, step, topt
    gc.collect()
    torch.cuda.empty_cache()
    if heldout is not None:
        with torch.no_grad():
            out["heldout"] = float(loss_fn(model, heldout)[1]["xent"])
    return out


def lm_train_report(tag: str, cfg, r: dict, tokens: int, mm: int, attn: tuple, card: str,
                    extra: str = "") -> None:
    """Prints a full-width run: losses, step ms (the median of the steps
    after the warm-up and the profiled one), tok/s, the
    optimizer's ms, peak bytes, the profiled step's busy ms, launches and
    idle share of its own time, the held-out xent beside the stream's
    entropy, and two FLOP bounds: the function's (6 N T and the attention
    pairs it needs, bf16 at the tensor cores' peak) and this
    implementation's (every kv block visited, the attention in f32 at the
    f32 peak).  `attn` is (needed, visited) attention FLOPs."""
    from repro_torch.launch import roofline
    from repro_torch.models.config import ShapeConfig

    fn_bound = (6 * mm * tokens + attn[0]) / BF16_OPS_PER_S * 1e3
    impl_bound = (6 * mm * tokens / BF16_OPS_PER_S + attn[1] / PEAK_OPS_PER_S) * 1e3
    if r["step_ms"]:
        med = statistics.median(r["step_ms"])
        mf = roofline.model_flops(cfg, ShapeConfig(tag, tokens, 1, "train"))
        timing = (f"step {med:.1f} ms (median of {len(r['step_ms'])} after a warm-up step of "
                  f"{r['first_ms']:.1f}, CUDA events), {tokens / (med / 1e3):.1f} tok/s, "
                  f"model-FLOP share {mf / (med / 1e3 * roofline.PEAK_FLOPS):.2%} "
                  f"(roofline.model_flops {mf:.6g}, 6 x active parameters x tokens, over the "
                  f"step x {roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s)")
        bounds = (f"FLOP bound of the function {fn_bound:.1f} ms ({6 * mm * tokens} FLOPs, 6 x "
                  f"{mm} parameters x {tokens} tokens, + {attn[0]} attention FLOPs over the "
                  f"pairs it needs, bf16 at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s), "
                  f"{fn_bound / med:.1%} of the step; of this implementation {impl_bound:.1f} "
                  f"ms (+ {attn[1]} attention FLOPs over every kv block, f32 at "
                  f"{PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s), {impl_bound / med:.1%}")
    else:
        timing = (f"steps not timed apart ({[round(t, 1) for t in [r['first_ms']] + r['step_ms']]}"
                  f" ms, CUDA events)")
        bounds = f"FLOP bound of the function {fn_bound:.1f} ms"
    prof = "not profiled"
    if r["prof"]:
        busy, launches, top, wall = r["prof"]
        prof = (f"the profiled step {busy:.1f} ms busy in {launches} launches "
                f"(torch.profiler, device only) of its own {wall:.1f} ms (CUDA events): idle "
                f"{1 - busy / wall:.1%}; top {top}")
    held = ""
    if "heldout" in r:
        held = (f"; held-out xent {r['heldout']:.4f} on the stream's next batch (unigram entropy "
                f"{token_entropy(cfg.vocab_size):.4f})")
    print(f"lm train ({tag}) {cfg.name}: losses {[round(x, 5) for x in r['losses']]}; {timing}; "
          f"optimizer {statistics.median(r['opt_ms']):.3f} ms (median of {len(r['opt_ms'])} "
          f"updates); peak {r['peak']} bytes; {prof}{held}; {bounds}{extra}; card {card}")


def lm_train_losses_fall(tag: str, runs: list, cfg) -> None:
    """The losses of `runs` in a row fall (the last below the first), every
    gradient is finite, and the held-out xent is not below the stream's
    entropy less LM_TRAIN_HELDOUT_SLACK: what fell is this batch learnt."""
    losses = [x for r in runs for x in r["losses"]]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"lm train ({tag}): losses {losses} do not fall")
    check(all(r["grads_finite"] and all(np.isfinite(m["grad_norm"]) for m in r["metrics"])
              for r in runs), f"lm train ({tag}): a gradient is not finite")
    floor = token_entropy(cfg.vocab_size) - LM_TRAIN_HELDOUT_SLACK
    check(runs[-1]["heldout"] >= floor,
          f"lm train ({tag}): held-out xent {runs[-1]['heldout']} below {floor}")


def lm_train_parity(dev) -> None:
    """(h): every arch's reduced config in f32, the card against the CPU."""
    from repro_torch.configs.registry import ARCH_IDS, get_arch
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.specs import _model_module
    from repro_torch.models.layers import ParamTree
    from repro_torch.train import make_optimizer, warmup_cosine

    rules = ShardingRules.make(None)
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        cfg = get_arch(arch).reduced
        name = get_arch(arch).config.optimizer
        mod = _model_module(cfg)
        tree = lm_numpy_tree(cfg, LM_SEED, mod.model_schema(cfg))
        host = lm_train_inputs(cfg, 2, LM_TRAIN_PARITY_SEQ, torch.device("cpu"))
        runs = []
        for d in (dev, torch.device("cpu")):
            model = ParamTree(mod.params_from_numpy(tree, cfg, d))
            loss, m = mod.loss_fn(model.tree(), {k: v.to(d) for k, v in host.items()}, cfg,
                                  rules)
            loss.backward()
            params = {n: p.detach() for n, p in model.named_parameters()}
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            opt = make_optimizer(name, warmup_cosine(*LM_TRAIN_LR))
            with torch.no_grad():
                opt.update({n: g.clone() for n, g in grads.items()}, opt.init(params), params)
            runs.append((float(loss.detach()), m, grads, params))
        (gl, gm, gg, gp), (cl, cm, cg, cp) = runs
        errs = {"loss": abs(gl - cl),
                "grads": max(float((gg[n].cpu() - cg[n]).abs().max()) for n in cg),
                "params": max(float((gp[n].cpu() - cp[n]).abs().max()) for n in cp)}
        check(np.isclose(gl, cl, rtol=1e-4, atol=1e-4)
              and all(torch.allclose(gg[n].cpu(), cg[n], rtol=1e-4, atol=1e-4) for n in cg)
              and all(torch.allclose(gp[n].cpu(), cp[n], rtol=1e-4, atol=1e-4) for n in cp)
              and all(bool(torch.isfinite(g).all()) for g in cg.values()),
              f"lm train (h) {arch}: {errs} from the CPU run's (rtol=atol=1e-4)")
        aux = f", moe_aux {float(gm['moe_aux']):.5g}" if cfg.n_experts else ""
        print(f"lm train (h): {cfg.name} f32, 2 x {LM_TRAIN_PARITY_SEQ}, loss {gl:.6f}{aux}; "
              f"loss within {errs['loss']:.3g}, {len(cg)} gradient leaves within "
              f"{errs['grads']:.3g}, one {name} update within {errs['params']:.3g} of the "
              f"CPU run (rtol=atol=1e-4; {time.perf_counter() - t0:.1f} s)")


def lm_train_h2o(dev, card: str) -> dict:
    """(i): h2o-danube-1.8b at full width, AdamW and then Adafactor on the
    trained weights, every Adafactor update witnessed; the first step's
    xent held against the serving forward's (``prefill_hidden``) on the
    same tokens.  Its first LM_TP_TRAIN[2] AdamW steps are the one-device
    witness of ``phase_lm_tp`` (r), the same function (the data ranks'
    rows as its 2 microbatches): returned, with each step's mean loss over
    the microbatches, gradient norm, lr and the parameters after it (host
    copies)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import ParamTree
    from repro_torch.train import make_optimizer, warmup_cosine

    cfg = get_arch("h2o-danube-1.8b").config
    b, s, k, n_adam, n_ada = LM_TRAIN_H2O
    rules = ShardingRules.make(None)
    model = ParamTree(T.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev))
    n_params = sum(p.numel() for p in model.parameters())
    batch = lm_train_inputs(cfg, b, s, dev)
    heldout = lm_train_inputs(cfg, b // k, s, dev, step=1)
    # the serving forward's xent on the last microbatch, the one whose
    # metrics the train step reports
    last = {key: v[b - b // k:] for key, v in batch.items()}
    with torch.no_grad():
        h, caches = T.prefill_hidden(model.tree(), last["tokens"], cfg, rules, s)
        del caches
        want = float(T.chunked_xent(model.tree(), h, last["labels"], last["mask"], cfg, rules))
        del h
    mb_losses: list = []  # each microbatch's loss, for (r)'s witness

    def loss_fn(m, x):
        loss, metrics = T.loss_fn(m.tree(), x, cfg, rules)
        mb_losses.append(loss.detach())
        return loss, metrics

    tp_b, tp_s, tp_n = LM_TP_TRAIN
    check((tp_b, tp_s, LM_TP_MESH[0]) == (b, s, k) and tp_n <= n_adam,
          "lm train (i): (r)'s witness needs (i)'s batch, microbatches and steps")
    tp_want: list = []

    def keep_for_tp(i, metrics):
        if i < tp_n:
            tp_want.append({"loss": float(torch.stack(mb_losses[-k:]).mean()),
                            "grad_norm": metrics["grad_norm"], "lr": metrics["lr"],
                            "top": max(float(p.detach().abs().max())
                                       for p in model.parameters()),
                            "blocks": tp_block_samples(dict(model.named_parameters()), cfg)})
        mb_losses.clear()

    mm, _ = matmul_params(cfg, model)
    attn = (attn_flops(cfg, b, s, visited=False), attn_flops(cfg, b, s))
    lr_fn = warmup_cosine(*LM_TRAIN_LR)
    witness: list = []
    runs = []
    for name, steps in (("adamw", n_adam), ("adafactor", n_ada)):
        wrap = None
        if name == "adafactor":  # on the weights the AdamW steps left
            wrap = lambda o: witnessed_adafactor(o, lr_fn, set(range(steps)),  # noqa: E731
                                                 n_params, witness)
        runs.append(lm_train_run(model, loss_fn, make_optimizer(name, lr_fn), batch, steps,
                                 microbatches=k, profile_at=1 if name == "adamw" else None,
                                 heldout=heldout, wrap=wrap,
                                 after_step=keep_for_tp if name == "adamw" else None))
        mb_losses.clear()
        lm_train_report(f"i, {name}", cfg, runs[-1], b * s, mm, attn, card,
                        f"; {n_params} parameters (f32), bf16 compute, remat {cfg.remat}, "
                        f"{b} x {s} in {k} microbatches")
    print(witness_line("i, adafactor", witness))
    check(all(r["ok"] for r in witness), f"lm train (i): Adafactor against plain: {witness}")
    q_flops = lm_train_useful(cfg, model, loss_fn, batch, k)
    lm_train_losses_fall("i", runs, cfg)
    got = runs[0]["metrics"][0]["xent"]
    print(f"lm train (i): the first step's xent {got:.6f} against prefill_hidden + "
          f"_logits_head on the same {b // k} x {s} tokens {want:.6f}: |diff| "
          f"{abs(got - want):.3g} (bound {LM_TRAIN_XENT_TOL})")
    check(abs(got - want) <= LM_TRAIN_XENT_TOL,
          f"lm train (i): the first step's xent {got} against the serving forward's {want}")
    shapes = {n: torch.empty(p.shape, device="meta") for n, p in model.named_parameters()}
    del model, batch, heldout
    gc.collect()
    torch.cuda.empty_cache()
    return {"cfg": cfg, "want": tp_want, "peak": runs[0]["peak"], "shapes": shapes,
            "q_flops": q_flops}


def lm_train_useful(cfg, model, loss_fn, batch: dict, k: int) -> int:
    """(q) for (i): the model FLOPs of a step over ``FlopCounterMode``'s
    count of its forward and backward (remat's recompute included): one
    microbatch counted, times the `k` of the same shape; outside the timed
    steps, the gradients dropped."""
    from repro_torch.launch import roofline
    from repro_torch.models.config import ShapeConfig

    b, s = batch["tokens"].shape
    part = {key: v[:b // k] for key, v in batch.items()}
    t0 = time.perf_counter()
    _, counted = roofline.count_flops(lambda: loss_fn(model, part)[0].backward())
    counted *= k
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    mf = roofline.model_flops(cfg, ShapeConfig("i", s, b, "train"))
    print(f"lm train (i): useful_ratio {mf / counted:.4f}: roofline.model_flops {mf:.6g} over "
          f"FlopCounterMode's {counted} FLOPs of a step's forward and backward ({k} x one "
          f"microbatch's count), remat's recompute included ({time.perf_counter() - t0:.1f} s, "
          f"outside the timed steps)")
    check(counted > 0, f"lm train (i): FlopCounterMode counted {counted} FLOPs")
    return counted


def lm_train_full(dev, card: str, tag: str, arch: str, overrides: dict, shape: tuple,
                  opt_name: str, lr: tuple = LM_TRAIN_LR) -> dict:
    """(j), (k), (l): an arch at full width (with `overrides`) for
    `shape` = (batch, seq, steps) under `opt_name` over warmup_cosine(*lr)
    (Adafactor's first update witnessed on every leaf up to
    LM_TRAIN_WITNESS_ELEMS); returns the run."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.specs import _model_module
    from repro_torch.models.layers import ParamTree
    from repro_torch.train import make_optimizer, warmup_cosine

    cfg = dataclasses.replace(get_arch(arch).config, **overrides)
    b, s, steps = shape
    mod = _model_module(cfg)
    rules = ShardingRules.make(None)
    t0 = time.perf_counter()
    model = ParamTree(mod.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev))
    n_params = sum(p.numel() for p in model.parameters())
    batch = lm_train_inputs(cfg, b, s, dev)
    heldout = lm_train_inputs(cfg, b, s, dev, step=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    loss_fn = lambda m, x: mod.loss_fn(m.tree(), x, cfg, rules)  # noqa: E731
    lr_fn = warmup_cosine(*lr)
    witness, wrap = [], None
    if opt_name == "adafactor":  # the warm-up step's update, outside the timed steps
        wrap = lambda o: witnessed_adafactor(o, lr_fn, {0}, LM_TRAIN_WITNESS_ELEMS,  # noqa: E731
                                             witness)
    r = lm_train_run(model, loss_fn, make_optimizer(opt_name, lr_fn), batch, steps,
                     heldout=heldout, wrap=wrap)
    dec, enc = matmul_params(cfg, model)
    mm = dec + enc  # enc-dec: as many frames as tokens
    enc_s = s if cfg.is_encdec else 0
    aux = (f", moe_aux {[round(m['moe_aux'], 5) for m in r['metrics']]}" if cfg.n_experts
           else "")
    lm_train_report(f"{tag}, {opt_name}", cfg, r, b * s, mm,
                    (attn_flops(cfg, b, s, enc_s, visited=False), attn_flops(cfg, b, s, enc_s)),
                    card,
                    f"; {n_params} parameters ({cfg.param_dtype}), {cfg.n_layers} layers"
                    f"{f' + {cfg.enc_layers} encoder layers' if cfg.is_encdec else ''}, "
                    f"bf16 compute, remat {cfg.remat}, batch {b} x {s}, warmup_cosine{lr}{aux}; "
                    f"built in "
                    f"{init_s:.1f} s")
    if witness:
        print(witness_line(f"{tag}, {opt_name}", witness))
        check(all(w["ok"] for w in witness), f"lm train ({tag}): Adafactor against plain: "
              f"{witness}")
    lm_train_losses_fall(tag, [r], cfg)
    r["cfg"] = cfg
    del model, batch, heldout
    gc.collect()
    torch.cuda.empty_cache()
    return r


def phase_lm_train(dev) -> dict:
    """LM training (``models.transformer.loss_fn``, ``models.encdec.loss_fn``,
    ``train.optimizer.adafactor``, ``launch.train --mode lm``):

    (h) every arch's reduced config in f32 from one seeded numpy tree: the
        loss, every gradient leaf and the parameters after one update of
        the full config's optimizer on the card within rtol=atol=1e-4 of
        the port's CPU run;
    (i) h2o-danube-1.8b at full width, f32 params, bf16 compute, "dots"
        remat, 4 x 4,096 in 2 microbatches: 3 AdamW steps, then 1
        Adafactor step on the weights they left, on one batch, the
        losses falling (the Adafactor leg's own need not: it starts on a
        batch already learnt); every Adafactor update within bounds of
        ``plain_adafactor`` on every leaf; the first step's xent within
        LM_TRAIN_XENT_TOL of ``prefill_hidden`` + ``_logits_head``'s on the
        same tokens;
    (j) mamba2-1.3b at full width (chunk 128, C14), 4 x 4,096, AdamW: every
        gradient finite, the losses falling;
    (k) seamless-m4t-medium at full width, 4 x 4,096 frames and tokens,
        AdamW over warmup_cosine(*LM_TRAIN_ENCDEC_LR), the losses falling;
    (l) one period of jamba-v0.1-52b in bf16 params, Adafactor: the MoE aux
        non-zero, the gradients finite, the losses falling, the first
        update within bounds of ``plain_adafactor`` on every leaf but the
        expert stacks;
    (m) ``python -m repro_torch.launch.train --mode lm`` with its defaults
        (mamba2-1.3b, batch 8, seq 256) but LM_TRAIN_CLI_STEPS steps, in
        process.

    Each full-width run prints its step ms (CUDA events; the median of the
    steps after a warm-up step and a profiled one), tok/s, the optimizer's ms,
    peak bytes, the profiled step's launches and idle share of its own time,
    its FLOP bounds, and the xent on the stream's next batch, held not
    below the stream's unigram entropy less LM_TRAIN_HELDOUT_SLACK (the
    tokens are drawn independently: the losses fall by learning one batch).
    None of the eight kernels is launched."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.kernels import fused
    from repro_torch.launch import train as t_train

    t_phase = time.perf_counter()
    card = card_line(CARD)
    fused.reset_launches()
    lm_train_parity(dev)
    h2o_witness = lm_train_h2o(dev, card)
    h2o_witness["j_peak"] = lm_train_full(dev, card, "j", "mamba2-1.3b", {}, LM_TRAIN_MAMBA,
                                          "adamw")["peak"]
    lm_train_full(dev, card, "k", "seamless-m4t-medium", {}, LM_TRAIN_ENCDEC, "adamw",
                  LM_TRAIN_ENCDEC_LR)
    r = lm_train_full(dev, card, "l", "jamba-v0.1-52b",
                      {"n_layers": 8, "param_dtype": "bfloat16"}, LM_TRAIN_JAMBA, "adafactor")
    check(all(m["moe_aux"] > 0 for m in r["metrics"]), "lm train (l): the MoE aux is zero")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        out = t_train.main(["--mode", "lm", "--steps", str(LM_TRAIN_CLI_STEPS)])
    lines = buf.getvalue().splitlines()
    print(f"lm train (m): python -m repro_torch.launch.train --mode lm --steps "
          f"{LM_TRAIN_CLI_STEPS}: " + " | ".join(lines) + f" ({time.perf_counter() - t0:.1f} s)")
    check(len(lines) == 2
          and lines[0].startswith(f"lm mamba2-1.3b: {LM_TRAIN_CLI_STEPS} steps in ")
          and len(out["losses"]) == LM_TRAIN_CLI_STEPS and all(np.isfinite(out["losses"]))
          and out["last_loss"] < out["first_loss"], f"lm train (m): {lines}")
    launched = {k: v for k, v in fused.LAUNCHES.items() if v}
    check(not launched, f"lm train: LM training launched {launched}")
    print(f"lm train: none of the eight kernels launched; {time.perf_counter() - t_phase:.1f} "
          f"s in all; card {card}")


# ---------------------------------------------------------------------------
# the meshed LM (phase_lm_mesh): rank programs are module-level, as
# phase_mesh's, and take numpy
    return h2o_witness


def cp_fill(t: torch.Tensor, layer: int, kv: int, first: int, fill: int) -> None:
    """Seeded bf16 values into `t` (B, S_slice, K, hd), the slice of one
    layer's k (kv 0) or v (kv 1) that starts at global position `first`:
    one draw a LM_CP_BLOCK block of positions, seeded by (layer, kv,
    block), so any rank fills its own slice with the whole cache's values;
    zeros from global position `fill` on."""
    g = torch.Generator(device=t.device)
    for off in range(0, t.shape[1], LM_CP_BLOCK):
        blk = (first + off) // LM_CP_BLOCK
        g.manual_seed(((LM_SEED * 64 + layer) * 2 + kv) * 64 + blk)
        part = t[:, off:off + LM_CP_BLOCK]
        part.normal_(generator=g)
        part[:, max(fill - first - off, 0):] = 0


def cp_model(dev):
    """The full h2o-danube-1.8b served in bf16, from LM_SEED."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T

    cfg = get_arch(LM_ARCH).config
    params = T.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev)
    served = T.cast_weights(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, served


def cp_caches(cfg, dev, first: int, length: int) -> dict:
    """The decode caches of positions [first, first + length), filled."""
    from repro_torch.models import transformer as T

    caches = T.init_cache(cfg, 1, length, dev)
    for j in range(cfg.n_periods):
        for kv, name in enumerate(("k", "v")):
            cp_fill(caches["p0"][name][j], j, kv, first, LM_CP_LEN - LM_MESH_GEN)
    return caches


def cp_positions(s_local: int) -> list:
    """The global positions whose layer-0 k (n) reads back after the
    border steps: the two written (rank 0's last slot, rank 1's first) and
    the two a write on the wrong rank would hit (rank 0's first slot, rank
    1's last)."""
    return [0, s_local - 1, s_local, LM_CP_LEN - 1]


def cp_decode_run(served, caches, cfg, rules, tokens, lens, mesh=None) -> dict:
    """Decode steps teacher-forced with `tokens` (B, 1) at cache lengths
    `lens`: each step's last logits (f32 numpy), ms (CUDA events around
    the call, synchronized), and on a mesh its collective bytes, calls and
    host ms in the collectives."""
    from repro_torch.models import transformer as T

    out = {"logits": [], "ms": [], "bytes": [], "calls": [], "gathers": [], "coll_ms": []}
    for tok, n in zip(tokens, lens):
        if mesh is not None:
            mesh.counter.reset()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        logits, caches = T.decode_step(served, tok, caches, n, cfg, rules, mesh=mesh,
                                       shard_kv_seq=mesh is not None)
        b.record()
        b.synchronize()
        out["ms"].append(a.elapsed_time(b))
        out["logits"].append(logits[:, -1].float().cpu().numpy())
        if mesh is not None:  # the combine's all-reduces; the FSDP gathers apart
            out["bytes"].append(mesh.counter.bytes["all-reduce"])
            out["calls"].append(mesh.counter.calls["all-reduce"])
            out["gathers"].append((mesh.counter.calls["all-gather"],
                                   mesh.counter.bytes["all-gather"]))
            out["coll_ms"].append(sum(mesh.counter.seconds.values()) * 1e3)
    return out


def cp_mesh_rank(mesh, tokens, lens, cross: int) -> dict:
    """(n) on one rank: its slice of the filled cache, the decode steps of
    `lens` with the witness's `tokens` context-parallel, the layer-0 k it
    holds at the probed positions after the first `cross` steps, C11."""
    from repro_torch.kernels import fused
    from repro_torch.launch.specs import shape_rules
    from repro_torch.models import transformer as T
    from repro_torch.models.config import SHAPES

    dev = mesh.device
    fused.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, served = cp_model(dev)
    rules = shape_rules(cfg, SHAPES["long_500k"], mesh)
    served = T.rank_params(served, cfg, rules)  # FSDP: the rank's rows of each weight
    gather_want = fsdp_reads(served, T.flat_rank_param_pspecs(cfg, rules), cfg)
    n = mesh.shape["data"]
    s_local = LM_CP_LEN // n
    first = mesh.coords["data"] * s_local
    t0 = time.perf_counter()
    caches = cp_caches(cfg, dev, first, s_local)
    torch.cuda.synchronize(dev)
    fill_s = time.perf_counter() - t0
    toks = [torch.from_numpy(t).to(dev) for t in tokens]
    r = cp_decode_run(served, caches, cfg, rules, toks[:cross], lens[:cross], mesh)
    k0 = caches["p0"]["k"][0]
    probes = {p: k0[:, p - first].float().cpu().numpy()
              for p in cp_positions(s_local) if first <= p < first + s_local}
    rest = cp_decode_run(served, caches, cfg, rules, toks[cross:], lens[cross:], mesh)
    for key in r:
        r[key] += rest[key]
    try:
        T.decode_step(served, toks[-1], caches, n * s_local, cfg, rules, mesh=mesh,
                      shard_kv_seq=True)
        c11 = None
    except ValueError as e:
        c11 = str(e)
    return dict(r, probes=probes, c11=c11, fill_s=fill_s, s_local=s_local,
                gather_want=gather_want, peak=torch.cuda.max_memory_allocated(dev),
                launches=dict(fused.LAUNCHES))


def fsdp_reads(params: dict, specs: dict, cfg) -> tuple:
    """(calls, bytes) of the FSDP gathers a forward makes: each leaf split
    over ``data`` gathered once a period (once for a top-level leaf), the
    rank's block of it in its dtype."""
    from repro_torch.distributed.sharding import spec_axes

    calls = nbytes = 0
    for name, t in flat_tree(params).items():
        if "data" in spec_axes(specs[name]):
            calls += cfg.n_periods if name.startswith("layers.") else 1
            nbytes += t.numel() * t.element_size()
    return calls, nbytes



def lm_cp(dev, card: str) -> list:
    """(n): the one-device witness over the whole cache, then the (data=2)
    world; returns the ranks' kernel launch counts."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import choose_transport, rank_devices, run_spmd

    n_ranks = 2
    s_local = LM_CP_LEN // n_ranks
    rng = np.random.default_rng(LM_SEED + 13)
    cfg, served = cp_model(dev)
    rules = ShardingRules.make(None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    caches = cp_caches(cfg, dev, 0, LM_CP_LEN)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    cache_bytes = sum(t.numel() * t.element_size() for t in lm_leaves(caches))
    # greedy from a seeded token: 2 steps across the slices' border, then
    # LM_MESH_GEN steps at the end of the cache
    runs = []
    for lens in ([s_local - 1, s_local], list(range(LM_CP_LEN - LM_MESH_GEN, LM_CP_LEN))):
        tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 1)).astype(np.int32)).to(dev)
        toks, r = [], {"logits": [], "ms": []}
        for n in lens:
            toks.append(tok)
            step = cp_decode_run(served, caches, cfg, rules, [tok], [n])
            for key in r:
                r[key] += step[key]
            tok = torch.from_numpy(step["logits"][0].argmax(-1).astype(np.int32)[:, None]).to(dev)
        runs.append((toks, lens, r))
        if len(runs) == 1:
            k0 = caches["p0"]["k"][0]
            probes = {p: k0[:, p].float().cpu().numpy() for p in cp_positions(s_local)}
    peak = torch.cuda.max_memory_allocated()
    # the last step again under the profiler (it rewrites its own position
    # with the same values)
    prof = lm_profile(lambda: cp_decode_run(served, caches, cfg, rules, toks[-1:], lens[-1:]))
    del caches, served
    gc.collect()
    torch.cuda.empty_cache()
    tokens = [t.cpu().numpy() for toks, _, _ in runs for t in toks]
    lens = [n for _, ls, _ in runs for n in ls]
    want = [x for _, _, r in runs for x in r["logits"]]
    w_ms = [x for _, _, r in runs for x in r["ms"]]
    cross = len(runs[0][1])
    free = torch.cuda.mem_get_info()[0]
    t1 = time.perf_counter()
    ranks = run_spmd(cp_mesh_rank, (n_ranks,), ("data",), device=dev,
                     args=(tokens, lens, cross), timeout=900)
    wall = time.perf_counter() - t1
    transport = choose_transport(rank_devices(n_ranks, dev))
    n_attn = cfg.n_periods * sum(s.kind == "attn" for s in cfg.period())
    g = cfg.n_heads // cfg.n_kv_heads
    want_bytes = n_attn * 4 * (2 * cfg.n_kv_heads * g + cfg.n_kv_heads * g * cfg.hd)
    errs = [float(max(np.abs(r["logits"][i] - want[i]).max() for r in ranks))
            for i in range(len(lens))]
    # step i's greedy token is step i + 1's input within a run
    fed = [i for i in range(len(lens) - 1) if i + 1 != cross]
    agree = {i: all(int(r["logits"][i].argmax()) == int(tokens[i + 1][0, 0]) for r in ranks)
             for i in fed}
    margin = {i: float(np.diff(np.sort(want[i][0])[-2:])[0]) for i in fed}
    clear = [agree[i] for i in fed if margin[i] > LM_BF16_TOL]
    agree = list(agree.values())
    same = all(np.array_equal(ranks[0]["logits"][i], r["logits"][i]) for r in ranks
               for i in range(len(lens)))
    probes_ok = all(np.array_equal(r["probes"][p], probes[p]) for r in ranks for p in r["probes"])
    owned = sorted(p for r in ranks for p in r["probes"])
    print(f"lm mesh (n) {cfg.name}: context-parallel decode at long_500k's shape, {n_ranks} ranks "
          f"on {dev} ({transport}), batch 1, {LM_CP_LEN} positions ({cache_bytes} bytes of bf16 "
          f"K/V; {ranks[0]['s_local']} a rank), filled to {LM_CP_LEN - LM_MESH_GEN} in "
          f"{fill_s:.2f} s (one device) and {[round(r['fill_s'], 2) for r in ranks]} s (ranks); "
          f"steps at cache_len {lens[:cross]} (across the border) and {lens[cross]}..{lens[-1]}; "
          f"step ms, median: ranks {[round(statistics.median(r['ms'][cross:]), 4) for r in ranks]}"
          f", one device {statistics.median(w_ms[cross:]):.4f} (CUDA events, synchronized a "
          f"step), of it in the collectives (host clock) "
          f"{[round(statistics.median(r['coll_ms'][cross:]), 4) for r in ranks]}; one device's "
          f"step under the profiler {prof[0]:.4f} ms busy in {prof[1]} launches, top {prof[2]}; "
          f"peak bytes {[r['peak'] for r in ranks]} a rank, one device {peak}; "
          f"all-reduce bytes a step {sorted({b for r in ranks for b in r['bytes']})} in calls "
          f"{sorted({c for r in ranks for c in r['calls']})} a rank (want {want_bytes} in "
          f"{3 * n_attn}), FSDP gathers (calls, bytes) a step "
          f"{sorted({g for r in ranks for g in r['gathers']})} (want "
          f"{tuple(ranks[0]['gather_want'])}); {free} bytes free before the spawn; the world "
          f"{wall:.1f} s; card {card}")
    print(f"lm mesh (n): logits against the one-device decode over the whole cache: max |diff| "
          f"{max(errs):.4g} (bound {LM_BF16_TOL}; by step {[round(e, 4) for e in errs]}); ranks "
          f"bitwise equal: {same}; greedy tokens equal where the margin passes the bound: "
          f"{sum(clear)} of {len(clear)} ({sum(agree)} of {len(agree)} in all); layer-0 k at "
          f"global positions {owned} bitwise the one-device cache's after the border steps: "
          f"{probes_ok}; C11 at {LM_CP_LEN}: {[r['c11'] for r in ranks]}")
    check(max(errs) <= LM_BF16_TOL, f"lm mesh (n): logits {errs} from one device's")
    check(same, "lm mesh (n): the ranks' logits differ")
    check(all(clear), "lm mesh (n): a greedy token differs where the margin passes the bound")
    check(probes_ok and owned == sorted(cp_positions(s_local)),
          f"lm mesh (n): a write landed on the wrong rank ({owned})")
    check(all(b == want_bytes for r in ranks for b in r["bytes"])
          and all(c == 3 * n_attn for r in ranks for c in r["calls"])
          and all(g == tuple(r["gather_want"]) for r in ranks for g in r["gathers"]),
          f"lm mesh (n): all-reduce bytes {ranks[0]['bytes'][:3]} calls {ranks[0]['calls'][:3]}, "
          f"gathers {ranks[0]['gathers'][:3]} (want {ranks[0]['gather_want']})")
    check(all(r["c11"] and f"outside the cache's {LM_CP_LEN}" in r["c11"] for r in ranks),
          f"lm mesh (n): C11 at {LM_CP_LEN}: {[r['c11'] for r in ranks]}")
    return [r["launches"] for r in ranks]


def ep_config():
    import dataclasses

    from repro_torch.configs.registry import get_arch

    return dataclasses.replace(get_arch("jamba-v0.1-52b").config, **LM_EP_OVERRIDES)


def ep_serve(served, cfg, rules, prompts, tokens, mesh=None) -> dict:
    """Prefill `prompts` and decode teacher-forced with `tokens` (B, LM_MESH_GEN;
    `tokens[:, 0]` the prefill's own greedy token when None): the prefill's
    last logits and each step's (f32 numpy), prefill ms, step ms, dropped
    choices of the prefill and of decode, and on a mesh the all-to-all
    bytes a decode step."""
    from repro_torch.models import transformer as T

    out = {"logits": [], "ms": [], "a2a": []}
    with moe_drops() as counts:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        logits, caches = T.prefill(served, prompts, cfg, rules, LM_EP_PROMPT + LM_MESH_GEN)
        b.record()
        b.synchronize()
        out["prefill_ms"] = a.elapsed_time(b)
        out["prefill"] = logits[:, -1].float().cpu().numpy()
        out["prefill_drops"] = total_drops(counts)
        n_prefill = len(counts)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        for i in range(LM_MESH_GEN - 1):
            if tokens is not None:
                tok = tokens[:, i:i + 1]
            if mesh is not None:
                mesh.counter.reset()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            logits, caches = T.decode_step(served, tok, caches, LM_EP_PROMPT + i, cfg, rules,
                                           mesh=mesh)
            b.record()
            b.synchronize()
            out["ms"].append(a.elapsed_time(b))
            out["logits"].append(logits[:, -1].float().cpu().numpy())
            if mesh is not None:
                out["a2a"].append(mesh.counter.bytes["all-to-all"])
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out["decode_drops"] = total_drops(counts[n_prefill:])
    return out


def ep_mesh_rank(mesh, prompts, tokens) -> dict:
    """(o) on one rank: its experts, its rows of the prompts, decode with
    the witness's tokens of its rows."""
    from repro_torch.distributed.sharding import ShardingRules, shard
    from repro_torch.kernels import fused
    from repro_torch.models import transformer as T

    dev = mesh.device
    fused.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = ep_config()
    rules = ShardingRules.make(mesh, LM_EP_RULE)
    t0 = time.perf_counter()
    served = T.cast_weights(T.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev,
                                          rules=rules), cfg)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in lm_leaves(served))
    row = rules.pspec("batch", None)
    rows = shard(torch.from_numpy(prompts), mesh, row).to(dev)
    toks = shard(torch.from_numpy(tokens), mesh, row).to(dev)
    out = ep_serve(served, cfg, rules, rows, toks, mesh)
    return dict(out, peak=torch.cuda.max_memory_allocated(dev), init_s=init_s,
                weight_bytes=weight_bytes, launches=dict(fused.LAUNCHES))


def lm_ep_witness(dev) -> dict:
    """(o)'s witness: the one-device dense dispatch, its greedy tokens."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import transformer as T

    cfg = ep_config()
    rng = np.random.default_rng(LM_SEED + 17)
    prompts = rng.integers(1, cfg.vocab_size, (LM_BATCH, LM_EP_PROMPT)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    served = T.cast_weights(T.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev), cfg)
    want = ep_serve(served, cfg, ShardingRules.make(None), torch.from_numpy(prompts).to(dev),
                    None)
    peak = torch.cuda.max_memory_allocated()
    del served
    gc.collect()
    torch.cuda.empty_cache()
    # the witness's greedy tokens, each step's input
    tokens = np.concatenate([want["prefill"].argmax(-1)[:, None]]
                            + [lg.argmax(-1)[:, None] for lg in want["logits"][:-1]],
                            axis=1).astype(np.int32)
    return {"cfg": cfg, "want": want, "peak": peak, "prompts": prompts, "tokens": tokens}


def lm_ep_check(w: dict, ranks: list, dev, card: str, free: int, wall: float) -> list:
    """(o)'s holds on the (data=2, model=1) world dispatching by
    all-to-all; returns the ranks' kernel launch counts."""
    from repro_torch.launch.mesh import choose_transport, rank_devices
    from repro_torch.models import moe

    cfg, want, peak = w["cfg"], w["want"], w["peak"]
    half = LM_BATCH // 2
    tol = LM_FULL_TOL["jamba-v0.1-52b"]
    errs, agree, clear = [], [], []
    for rank, r in enumerate(ranks):
        rows = slice(rank * half, (rank + 1) * half)
        got = [r["prefill"]] + r["logits"]
        ref = [want["prefill"][rows]] + [w[rows] for w in want["logits"]]
        errs.append(max(float(np.abs(g - w).max()) for g, w in zip(got, ref)))
        for g, w in zip(got[:-1], ref[:-1]):
            top2 = np.sort(w, axis=-1)[:, -2:]
            ok = g.argmax(-1) == w.argmax(-1)
            agree.append(bool(ok.all()))
            clear.append(bool(ok[(top2[:, 1] - top2[:, 0]) > tol].all()))
    a2a = sorted({b for r in ranks for b in r["a2a"]})
    transport = choose_transport(rank_devices(2, dev))
    e_local = cfg.n_experts // 2
    # a decode step: every MoE layer sends its (rows, E, C, d) bf16 buffers out and back
    want_a2a = (cfg.n_periods * sum(s.mlp_kind == "moe" for s in cfg.period()) * 2 * half
                * cfg.n_experts * moe.capacity_of(1, cfg) * cfg.d_model * 2)
    print(f"lm mesh (o) {cfg.name}: one period ({cfg.n_layers} layers) under the expert rule "
          f"{LM_EP_RULE}, (data=2, model=1) on {dev} ({transport}), {e_local} experts a rank, "
          f"batch {LM_BATCH} ({half} a rank), prompt {LM_EP_PROMPT}, {LM_MESH_GEN} generated: prefill "
          f"s {[round(r['prefill_ms'] / 1e3, 4) for r in ranks]} (ranks), "
          f"{want['prefill_ms'] / 1e3:.4f} (one device, dense); decode ms a step, median "
          f"{[round(statistics.median(r['ms']), 4) for r in ranks]} (ranks), "
          f"{statistics.median(want['ms']):.4f} (one device; CUDA events, synchronized a step); "
          f"all-to-all bytes a decode step a rank {a2a} (want {want_a2a}); weights "
          f"{[r['weight_bytes'] for r in ranks]} bytes a rank, built in "
          f"{[round(r['init_s'], 1) for r in ranks]} s; peak {[r['peak'] for r in ranks]} bytes "
          f"a rank, one device {peak}; {free} bytes free before the spawn; the world of (o) "
          f"and (p) {wall:.1f} s; card {card}")
    print(f"lm mesh (o): logits against the one-device dense dispatch: max |diff| "
          f"{[round(e, 5) for e in errs]} by rank (bound {tol}); greedy tokens equal "
          f"{sum(agree)} of {len(agree)} steps and ranks, where the margin passes the bound "
          f"{sum(clear)} of {len(clear)}; dropped choices, prefill: ranks "
          f"{[r['prefill_drops'] for r in ranks]}, one device {want['prefill_drops']}; decode: "
          f"{[r['decode_drops'] for r in ranks]}, {want['decode_drops']}")
    check(max(errs) <= tol, f"lm mesh (o): logits {errs} from the dense dispatch's")
    check(all(clear), "lm mesh (o): a greedy token differs where the margin passes the bound")
    check(sum(r["prefill_drops"] for r in ranks) == want["prefill_drops"]
          and all(r["decode_drops"] == 0 for r in ranks) and want["decode_drops"] == 0,
          "lm mesh (o): the drops differ from the dense dispatch's")
    check(a2a == [want_a2a], f"lm mesh (o): all-to-all bytes a step {a2a}, want {want_a2a}")
    return [r["launches"] for r in ranks]


def ep_both_rank(mesh, prompts, tokens, tree, batch) -> dict:
    """(o), then (p), on one rank of one (data=2, model=1) world."""
    out = {"o": ep_mesh_rank(mesh, prompts, tokens)}
    gc.collect()
    torch.cuda.empty_cache()
    out["p"] = ep_train_rank(mesh, tree, batch)
    return out


def ep_train_inputs(cfg) -> dict:
    b, s = LM_EP_TRAIN
    toks = np.random.default_rng(LM_SEED + 19).integers(1, cfg.vocab_size, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((b, s), np.float32)}


def ep_train_step(cfg, model, rules, **kw):
    from repro_torch.models import transformer as T
    from repro_torch.train import (Layout, init_state, make_optimizer, make_train_step,
                                   warmup_cosine)

    opt = make_optimizer("adamw", warmup_cosine(*LM_TRAIN_LR))
    step = make_train_step(lambda m, b: T.loss_fn(m.tree(), b, cfg, rules), opt, rules=rules,
                           **kw)
    layout = None if rules.mesh is None else Layout(rules.mesh, kw["param_specs"])
    return step, init_state(model, opt, layout=layout)


def ep_train_rank(mesh, tree, batch) -> dict:
    """(p) on one rank: one meshed AdamW step of the reduced llama4 under
    its expert rule, its rows of `batch`."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import ShardingRules, shard
    from repro_torch.kernels import fused
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import ParamTree

    dev = mesh.device
    fused.reset_launches()
    mesh.counter.reset()
    cfg = get_arch("llama4-maverick-400b-a17b").reduced
    rules = ShardingRules.make(mesh, LM_EP_RULE)
    model = ParamTree(T.rank_params(T.params_from_numpy(tree, cfg, dev), cfg, rules))
    specs = T.flat_rank_param_pspecs(cfg, rules)
    step, state = ep_train_step(cfg, model, rules, param_specs=specs)
    rows = {k: shard(torch.from_numpy(v), mesh, rules.pspec("batch", None)).to(dev)
            for k, v in batch.items()}
    _, metrics = step(state, rows)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.cpu().numpy() for k, p in model.named_parameters()},
            "params": {k: p.detach().cpu().numpy() for k, p in model.named_parameters()},
            "specs": specs, "a2a": mesh.counter.calls["all-to-all"],
            "launches": dict(fused.LAUNCHES)}


def lm_ep_train_witness() -> dict:
    """(p)'s witness: the CPU's one-device step over 2 microbatches."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import ParamTree

    cfg = get_arch("llama4-maverick-400b-a17b").reduced
    tree = lm_numpy_tree(cfg, LM_SEED)
    batch = ep_train_inputs(cfg)
    rules = ShardingRules.make(None)
    model = ParamTree(T.params_from_numpy(tree, cfg, "cpu"))
    step, state = ep_train_step(cfg, model, rules, microbatches=2)
    cpu_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    half = LM_EP_TRAIN[0] // 2
    with torch.no_grad():
        losses = [float(T.loss_fn(model.tree(), {k: v[i:i + half] for k, v in cpu_batch.items()},
                                  cfg, rules)[0]) for i in (0, half)]
    _, metrics = step(state, cpu_batch)
    return {"cfg": cfg, "tree": tree, "batch": batch, "model": model, "metrics": metrics,
            "losses": losses}


def lm_ep_train_check(w: dict, ranks: list, dev, card: str, wall: float) -> list:
    """(p)'s holds on the world's expert-parallel step; returns the ranks'
    kernel launch counts."""
    import types

    from repro_torch.distributed.sharding import shard, spec_axes

    cfg, model, metrics, losses = w["cfg"], w["model"], w["metrics"], w["losses"]
    errs = {"loss": abs(ranks[0]["metrics"]["loss"] - float(np.mean(losses))),
            "grad_norm": abs(ranks[0]["metrics"]["grad_norm"] - float(metrics["grad_norm"]))}
    worst = {"grads": 0.0, "params": 0.0}
    ok = True
    named = dict(model.named_parameters())
    for rank, r in enumerate(ranks):
        mesh = types.SimpleNamespace(shape={"data": 2, "model": 1}, axis_names=("data", "model"),
                                     coords={"data": rank, "model": 0})
        for name, p in named.items():
            spec = r["specs"][name]
            for key, want in (("grads", p.grad), ("params", p.detach())):
                w = shard(want, mesh, spec).numpy()
                g = r[key][name]
                worst[key] = max(worst[key], float(np.abs(g - w).max()))
                ok &= bool(np.allclose(g, w, rtol=LM_EP_TRAIN_TOL, atol=LM_EP_TRAIN_TOL))
    split = sorted({n for r in ranks for n, g in r["grads"].items()
                    if g.shape != tuple(named[n].shape)})
    print(f"lm mesh (p) {cfg.name}: one meshed AdamW step under {LM_EP_RULE}, f32, "
          f"{LM_EP_TRAIN[0]} x {LM_EP_TRAIN[1]} on (data=2, model=1) on {dev}, against the "
          f"CPU's one-device step over 2 microbatches (the ranks' rows): loss "
          f"{ranks[0]['metrics']['loss']:.7f} against {np.mean(losses):.7f} (|diff| "
          f"{errs['loss']:.3g}), grad_norm |diff| {errs['grad_norm']:.3g}; max |diff| of every "
          f"gradient block {worst['grads']:.3g}, of the updated parameters "
          f"{worst['params']:.3g} (rtol=atol={LM_EP_TRAIN_TOL}); the split leaves {split}; "
          f"all-to-all calls a rank {[r['a2a'] for r in ranks]}; the world of (o) and (p) "
          f"{wall:.1f} s; card "
          f"{card}")
    check(ok and errs["loss"] <= LM_EP_TRAIN_TOL, f"lm mesh (p): {errs}, {worst}")
    want_split = sorted(n for n, sp in ranks[0]["specs"].items() if "data" in spec_axes(sp))
    check(split == want_split and any(n.endswith("w_gate") for n in split)
          and all(r["a2a"] == 8 for r in ranks),
          f"lm mesh (p): split {split}, all-to-alls {[r['a2a'] for r in ranks]}")
    return [r["launches"] for r in ranks]


def phase_lm_mesh(dev) -> None:
    """The meshed LM (``models.layers.cp_decode_attention``,
    ``models.moe._moe_apply_a2a``, ``distributed.comm.all_to_all``), ranks
    sharing the card over gloo staged through pinned memory (NCCL refuses
    two ranks on one card), so the times say little of collectives and
    parity is the bar; each witness runs in this process first and is freed
    before the spawn:

    (n) context-parallel decode of the full h2o-danube-1.8b at long_500k's
        shape (batch 1, LM_CP_LEN positions) on (data=2), each rank filling
        its own slice: 2 steps across the slices' border (the writes land
        on the owning rank, layer 0's k bitwise the one-device cache's),
        then LM_MESH_GEN steps at the end of the cache, teacher-forced with the
        one-device decode's greedy tokens, the logits within LM_BF16_TOL,
        the ranks' bitwise equal, one pmax and two psums an attention layer,
        C11 at the global length;
    (o) expert-parallel serving: one period of jamba-v0.1-52b under llama4's
        expert rule on (data=2, model=1), LM_BATCH x LM_EP_PROMPT, LM_MESH_GEN
        generated, against the one-device dense dispatch: logits within
        (f)'s bound, the drops equal, the all-to-all bytes a decode step;
    (p) expert-parallel training: one meshed AdamW step of the reduced
        llama4 in f32 against the CPU's one-device step over 2 microbatches
        (the same function), every gradient block and updated parameter
        within LM_EP_TRAIN_TOL.

    (o) and (p) run in one world, one after the other (one spawn).  None of
    the eight kernels is launched, by the witnesses in this process or by
    any rank."""
    from repro_torch.kernels import fused

    t0 = time.perf_counter()
    card = card_line(CARD)
    fused.reset_launches()
    from repro_torch.launch.mesh import run_spmd

    counts = lm_cp(dev, card)
    o, p = lm_ep_witness(dev), lm_ep_train_witness()
    free, t1 = torch.cuda.mem_get_info()[0], time.perf_counter()
    ranks = run_spmd(ep_both_rank, (2, 1), ("data", "model"), device=dev,
                     args=(o["prompts"], o["tokens"], p["tree"], p["batch"]), timeout=900)
    wall = time.perf_counter() - t1
    counts += (lm_ep_check(o, [r["o"] for r in ranks], dev, card, free, wall)
               + lm_ep_train_check(p, [r["p"] for r in ranks], dev, card, wall))
    counts.append(dict(fused.LAUNCHES))
    launched = {k: sum(c.get(k, 0) for c in counts) for k in fused.LAUNCHES}
    launched = {k: v for k, v in launched.items() if v}
    check(not launched, f"lm mesh: the meshed LM launched {launched}")
    print(f"lm mesh: none of the eight kernels launched, by the witnesses or by the "
          f"{len(counts) - 1} rank runs of (n)-(p); {time.perf_counter() - t0:.1f} s in all; "
          f"card {card}")


# ---------------------------------------------------------------------------
# the LM's tensor-parallel and FSDP layout (phase_lm_tp): rank programs are
# module-level and take numpy


def tp_shapes(b: int, s: int, max_seq: int) -> dict:
    from repro_torch.models.config import ShapeConfig

    return {"train": ShapeConfig("lm_tp_train", s, b, "train"),
            "prefill": ShapeConfig("lm_tp_prefill", s, b, "prefill"),
            "decode": ShapeConfig("lm_tp_decode", max_seq, b, "decode")}


def tp_train_model(cfg, dev, rules):
    """h2o's seeded model as this rank's blocks under meshed `rules`, its
    AdamW, its state (the reference's layout) and the blocks' specs."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import ParamTree
    from repro_torch.train import Layout, init_state, make_optimizer, warmup_cosine

    model = ParamTree(T.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev,
                                    rules=rules))
    opt = make_optimizer("adamw", warmup_cosine(*LM_TRAIN_LR))
    specs = T.flat_rank_param_pspecs(cfg, rules)
    return model, opt, init_state(model, opt, layout=Layout(rules.mesh, specs)), specs


def tp_sample(t: torch.Tensor) -> torch.Tensor:
    """Every k-th element of `t` flattened, k = numel // LM_TP_SAMPLE (at
    least 1), as an f32 host copy: a block's sample that a witness takes
    from the same block of its own tensor."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // LM_TP_SAMPLE)].to("cpu", torch.float32, copy=True)


def tp_block_samples(params: dict, cfg) -> list:
    """Each rank of LM_TP_MESH's ``tp_sample`` of its block of every one of
    `params` (by dotted name) and the blocks' specs, as (r)'s ranks lay
    them out: the witness keeps these, not two host copies of the whole
    parameters beside the spawned world."""
    from repro_torch.distributed.sharding import shard
    from repro_torch.launch.specs import shape_rules
    from repro_torch.models import transformer as T

    b, s, _ = LM_TP_TRAIN
    out = []
    for rank in range(math.prod(LM_TP_MESH)):
        mesh = meta_mesh(dict(zip(("data", "model"), LM_TP_MESH)), rank)
        specs = T.flat_rank_param_pspecs(cfg, shape_rules(cfg, tp_shapes(b, s, s)["train"], mesh))
        out.append({"specs": specs, "samples": {n: tp_sample(shard(p, mesh, specs[n])).numpy()
                                                for n, p in params.items()}})
    return out


def tp_train_steps(step, state, batch: dict, model, n: int, mesh) -> list:
    """`n` meshed steps: each one's loss (the mean over the batch axes),
    grad norm, lr, ms (CUDA events), collective bytes, calls and host
    seconds, and the parameter blocks' samples after it (``tp_sample``)."""
    out = []
    for _ in range(n):
        mesh.counter.reset()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        b.synchronize()
        out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "lr": float(m["lr"]), "ms": a.elapsed_time(b),
                    "bytes": dict(mesh.counter.bytes), "calls": dict(mesh.counter.calls),
                    "coll_s": sum(mesh.counter.seconds.values()),
                    "params": {k: tp_sample(p).numpy() for k, p in model.named_parameters()}})
    return out


def tp_train_rank(mesh) -> dict:
    """(r) on one rank: its blocks of h2o, its rows of the batch, the
    meshed steps."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed.sharding import shard
    from repro_torch.kernels import fused
    from repro_torch.launch.specs import shape_rules
    from repro_torch.models import transformer as T
    from repro_torch.train import make_train_step

    dev = mesh.device
    fused.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(LM_ARCH).config, remat=LM_TP_REMAT)
    b, s, n = LM_TP_TRAIN
    rules = shape_rules(cfg, tp_shapes(b, s, s)["train"], mesh)
    model, opt, state, specs = tp_train_model(cfg, dev, rules)
    step = make_train_step(lambda m, x: T.loss_fn(m.tree(), x, cfg, rules), opt, rules=rules,
                           param_specs=specs)
    rows = (*rules.pspec("batch"), None)
    batch = {k: shard(v, mesh, rows).to(dev)
             for k, v in lm_train_inputs(cfg, b, s, torch.device("cpu")).items()}
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    steps = tp_train_steps(step, state, batch, model, n, mesh)
    return {"steps": steps, "setup_s": setup_s, "specs": specs, "peak": torch.cuda.max_memory_allocated(dev),
            "launches": dict(fused.LAUNCHES), "memory": rank_memory(dev)}


def tp_train_comm(cfg, rows: int, seq: int, mesh_shape: tuple, params: dict) -> dict:
    """The collectives one meshed train step of the dense decoder should
    make on a rank, (calls, bytes) by kind, from the layout alone.  Remat
    "dots" or "full": the backward recomputes each period's forward up to
    the last tensor it needs (``torch.utils.checkpoint`` stops early), so
    the weights' gathers and the attention's sum run twice and the MLP's
    sum, whose output only the next period reads, once; the
    cross-entropy's blocks ("full" remat) run twice.  `params` are the global parameters'
    shapes by dotted name (meta tensors)."""
    from repro_torch.distributed.sharding import ShardingRules, entry_axes, spec_axes
    from repro_torch.models import transformer as T
    from repro_torch.train import make_optimizer
    from repro_torch.train.step import natural_opt_specs, opt_state_pspecs

    data, model = mesh_shape
    mesh = meta_mesh({"data": data, "model": model})
    rules = ShardingRules.make(mesh, dict(cfg.sharding_overrides))
    specs = T.flat_rank_param_pspecs(cfg, rules)
    d, L, bf16, f32 = cfg.d_model, cfg.n_periods, 2, 4
    tok = rows * seq
    blk = min(1024, seq)
    nb = seq // blk
    vocab = cfg.padded_vocab // model
    layer = sum(math.prod(t.shape[1:]) // (data * model) for n, t in params.items()
                if n.startswith("layers.") and "data" in spec_axes(specs[n]))
    n_fsdp = sum(1 for n in params if n.startswith("layers.") and "data" in spec_axes(specs[n]))
    head = d // data * vocab
    ag_calls, ag_bytes = 2 * n_fsdp * L + 2 * nb, (2 * L * layer + 2 * nb * head) * bf16
    # the optimizer state's leaves that the reference lays out by another
    # parameter's spec go to their own parameter's layout and back
    opt = make_optimizer("adamw", lambda step: torch.zeros(()))
    ref = flat_tree(opt_state_pspecs(opt, params, specs))
    nat = flat_tree(natural_opt_specs(opt, params, specs))
    for name, src in ref.items():
        if tuple(src) == tuple(nat[name]):
            continue
        shape = list(params[name.split(".", 1)[1]].shape)
        for spec_a, spec_b in ((src, nat[name]), (nat[name], src)):
            cur = [n // math.prod(mesh.shape[a] for a in entry_axes(e)) for n, e in
                   zip(shape, spec_a)]
            for dim, (ea, eb) in enumerate(zip(spec_a, spec_b)):
                if entry_axes(ea) == entry_axes(eb):
                    continue
                for axis in reversed(entry_axes(ea)):
                    if mesh.shape[axis] > 1:
                        ag_calls += 1
                        ag_bytes += math.prod(cur) * f32
                        cur[dim] *= mesh.shape[axis]
    small = [n for n in params if "data" not in spec_axes(specs[n])]
    groups = {tuple(spec_axes(sp)) for sp in specs.values()}
    ar_calls = (3 * L + 1 + 6 * nb) + (2 * L + n_fsdp * L + 2 * nb) + len(small) + sum(
        len(g) for g in groups) + 1
    ar_bytes = ((3 * L + 1) * tok * d * bf16 + 6 * nb * rows * blk * f32
                + 2 * L * tok * d * bf16 + L * data * layer * bf16
                + nb * rows * blk * d * bf16 + nb * d * vocab * bf16
                + sum(math.prod(params[n].shape) // model ** ("model" in spec_axes(specs[n]))
                      for n in small) * f32
                + (sum(len(g) for g in groups) + 1) * f32)
    return {"all-gather": (ag_calls, ag_bytes), "all-reduce": (ar_calls, ar_bytes)}


def meta_mesh(shape: dict, rank: int = 0):
    """Rank `rank`'s view of a mesh of `shape` with no world behind it."""
    from repro_torch.launch.mesh import Mesh

    return Mesh(dict(shape), rank, torch.device("meta"), "none")


def flat_tree(tree, path: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{path}.{k}" if path else k
        out.update(flat_tree(v, name) if isinstance(v, dict) else {name: v})
    return out


def lm_tp_train_check(w: dict, ranks: list, dev, card: str, free: int, wall: float) -> list:
    """(r)'s holds on the world's `ranks` against the witness `w`; returns
    the ranks' kernel launch counts."""
    from repro_torch.launch.mesh import choose_transport, rank_devices

    cfg, want, peak = w["cfg"], w["want"], w["peak"]
    b, s, n = LM_TP_TRAIN
    transport = choose_transport(rank_devices(math.prod(LM_TP_MESH), dev))
    comm = tp_train_comm(cfg, b // LM_TP_MESH[0], s, LM_TP_MESH, w["shapes"])
    # an AdamW step moves an element by at most lr (|m^ / sqrt(v^)| <= 1 on
    # the first step, about 1 on the next), so two runs' parameters part by
    # at most 2 lr a step, beside the f32 rounding of p + update on each side
    top = want[0]["top"]
    bound, worst, ok = 2 * 2.0 ** -23 * top, [], True
    for i, w in enumerate(want):
        bound += 2 * w["lr"]
        err = 0.0
        for r, blocks in zip(ranks, w["blocks"]):
            check(r["specs"] == blocks["specs"], "lm tp (r): a rank's specs are not the witness's")
            for name, got in r["steps"][i]["params"].items():
                err = max(err, float(np.abs(got - blocks["samples"][name]).max()))
        worst.append(err)
        ok &= err <= bound
    for r in [*want, *(st for r in ranks for st in r["steps"])]:
        r.pop("params", None), r.pop("blocks", None)
    got = [[st["loss"] for st in r["steps"]] for r in ranks]
    norms = [[st["grad_norm"] for st in r["steps"]] for r in ranks]
    w_loss = [w["loss"] for w in want]
    print(f"lm tp (r) {cfg.name}: training at full width on {LM_TP_MESH} (data, model) on {dev} "
          f"({transport}), {b} x {s}, bf16 compute, remat {LM_TP_REMAT} (the witness "
          f"{cfg.remat}), {n} AdamW steps: step ms "
          f"{[[round(st['ms'], 1) for st in r['steps']] for r in ranks]} by rank (CUDA events), "
          f"of it in the collectives (host clock) "
          f"{[[round(st['coll_s'] * 1e3, 1) for st in r['steps']] for r in ranks]}; one device "
          f"over {LM_TP_MESH[0]} microbatches: (i)'s first steps; a rank's model, optimizer "
          f"state and batch built in {[round(r['setup_s'], 1) for r in ranks]} s; peak bytes "
          f"{[r['peak'] for r in ranks]} a rank, one device {peak}; {free} bytes free before "
          f"the spawn; the world of (r) and (s) {wall:.1f} s; card {card}")
    for kind in ("all-gather", "all-reduce"):
        seen = sorted({(st["calls"][kind], st["bytes"][kind]) for r in ranks for st in r["steps"]})
        print(f"lm tp (r): {kind} (calls, bytes) a step a rank {seen}, predicted {comm[kind]}")
    other = {k for r in ranks for st in r["steps"] for k, v in st["calls"].items()
             if v and k not in comm}
    print(f"lm tp (r): loss by step {got[0]} (ranks equal: {all(g == got[0] for g in got)}) "
          f"against one device's {w_loss} (bound {LM_TP_LOSS_TOL}); grad norm {norms[0]} "
          f"against {[w['grad_norm'] for w in want]} (bound {LM_TP_NORM_TOL} of it); every "
          f"parameter block after each step ({LM_TP_SAMPLE} evenly spaced elements of each) within "
          f"{[round(e, 6) for e in worst]} of one "
          f"device's (bounds, 2 lr a step and 2^-22 of the largest parameter {top:.4g}: "
          f"{[round(2 * sum(x['lr'] for x in want[:i + 1]) + 2 * 2.0 ** -23 * top, 6) for i in range(n)]})")
    check(all(g == got[0] for g in got), "lm tp (r): the ranks' losses differ")
    check(all(abs(a - w) <= LM_TP_LOSS_TOL for a, w in zip(got[0], w_loss)),
          f"lm tp (r): losses {got[0]} against {w_loss}")
    check(all(abs(a - w["grad_norm"]) <= LM_TP_NORM_TOL * w["grad_norm"]
              for a, w in zip(norms[0], want)), f"lm tp (r): grad norms {norms[0]}")
    check(ok, f"lm tp (r): parameter blocks {worst} from one device's")
    check(not other and all((st["calls"][k], st["bytes"][k]) == comm[k] for r in ranks
                            for st in r["steps"] for k in comm),
          f"lm tp (r): collectives {ranks[0]['steps'][0]['calls']} "
          f"{ranks[0]['steps'][0]['bytes']}, predicted {comm}")
    return [r["launches"] for r in ranks]


def tp_serve(served, cfg, prules, drules, prompts, tokens, steps: int, mesh=None) -> dict:
    """Prefill `prompts` under `prules`, then `steps` decode steps under
    `drules` (the prefill's caches resharded to them on a mesh),
    teacher-forced with `tokens` (B, steps; the decode's own greedy tokens
    when None): the prefill's last logits and each step's (f32 numpy, the
    whole vocab), prefill and reshard ms, step ms, the drops of the MoE
    layers, and on a mesh each step's collective bytes by kind and the
    reshard's."""
    from repro_torch.models import transformer as T

    out = {"logits": [], "ms": [], "bytes": []}
    max_seq = prompts.shape[1] + steps
    with moe_drops() as counts:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        logits, caches = T.prefill(served, prompts, cfg, prules, max_seq)
        logits = T.gather_logits(logits, prules)
        b.record()
        b.synchronize()
        out["prefill_ms"] = a.elapsed_time(b)
        out["prefill"] = logits[:, -1].float().cpu().numpy()
        out["prefill_drops"] = total_drops(counts)
        n_prefill = len(counts)
        if mesh is not None:
            mesh.counter.reset()
            t0 = time.perf_counter()
            caches = T.reshard_caches(caches, cfg, prules, drules)
            torch.cuda.synchronize()
            out["reshard_ms"] = (time.perf_counter() - t0) * 1e3
            out["reshard_bytes"] = dict(mesh.counter.bytes)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        for i in range(steps):
            if tokens is not None:
                tok = tokens[:, i:i + 1]
            if mesh is not None:
                mesh.counter.reset()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            logits, caches = T.decode_step(served, tok, caches, prompts.shape[1] + i, cfg,
                                           drules, mesh=mesh)
            logits = T.gather_logits(logits, drules)
            b.record()
            b.synchronize()
            out["ms"].append(a.elapsed_time(b))
            out["logits"].append(logits[:, -1].float().cpu().numpy())
            if mesh is not None:
                out["bytes"].append(dict(mesh.counter.bytes))
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out["decode_drops"] = total_drops(counts[n_prefill:])
    return out


def tp_h2o_rank(mesh, prompts, tokens) -> dict:
    """(r), then (s), on one rank of one world (one spawn for both)."""
    out = {"r": tp_train_rank(mesh)}
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = tp_serve_rank(mesh, "s", prompts, tokens)
    return out


def tp_serve_rank(mesh, arch_key: str, prompts, tokens) -> dict:
    """(s) or (t) on one rank: the rank's blocks of the served weights
    (bf16), its rows of the prompts, the witness's tokens of its rows."""
    from repro_torch.distributed.sharding import shard
    from repro_torch.kernels import fused
    from repro_torch.launch.specs import shape_rules
    from repro_torch.models import transformer as T

    dev = mesh.device
    fused.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, (b, p, steps) = tp_serve_config(arch_key)
    cells = tp_shapes(b, p, p + steps)
    prules, drules = shape_rules(cfg, cells["prefill"], mesh), shape_rules(cfg, cells["decode"], mesh)
    t0 = time.perf_counter()
    served = T.cast_weights(T.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev,
                                          rules=prules), cfg)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in lm_leaves(served))
    row = (*prules.pspec("batch"), None)
    out = tp_serve(served, cfg, prules, drules, shard(torch.from_numpy(prompts), mesh, row).to(dev),
                   shard(torch.from_numpy(tokens), mesh, row).to(dev), steps, mesh)
    return dict(out, peak=torch.cuda.max_memory_allocated(dev), init_s=init_s,
                weight_bytes=weight_bytes, rows=shard(torch.arange(b), mesh, row[:1]).tolist(),
                launches=dict(fused.LAUNCHES), memory=rank_memory(dev))


def tp_serve_config(arch_key: str):
    """(config, (batch, prompt, decode steps)) of (s) or (t)."""
    from repro_torch.configs.registry import get_arch

    if arch_key == "s":
        return get_arch(LM_ARCH).config, LM_TP_SERVE
    return ep_config(), LM_TP_JAMBA


def lm_tp_serve_witness(dev, arch_key: str) -> dict:
    """(s)'s or (t)'s one-device witness: the prompts, the served logits and
    the greedy tokens that teacher-force the ranks."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.models import transformer as T

    cfg, (b, p, steps) = tp_serve_config(arch_key)
    rng = np.random.default_rng(LM_SEED + (23 if arch_key == "s" else 29))
    prompts = rng.integers(1, cfg.vocab_size, (b, p)).astype(np.int32)
    none = ShardingRules.make(None)
    torch.cuda.reset_peak_memory_stats()
    served = T.cast_weights(T.init_params(torch.Generator().manual_seed(LM_SEED), cfg, dev), cfg)
    weight_bytes = sum(t.numel() * t.element_size() for t in lm_leaves(served))
    want = tp_serve(served, cfg, none, none, torch.from_numpy(prompts).to(dev), None, steps)
    peak = torch.cuda.max_memory_allocated()
    del served
    gc.collect()
    torch.cuda.empty_cache()
    tokens = np.concatenate([want["prefill"].argmax(-1)[:, None]]
                            + [lg.argmax(-1)[:, None] for lg in want["logits"][:-1]],
                            axis=1).astype(np.int32)
    return {"key": arch_key, "cfg": cfg, "want": want, "prompts": prompts, "tokens": tokens,
            "weight_bytes": weight_bytes, "peak": peak}


def lm_tp_serve_check(w: dict, ranks: list, dev, card: str, mesh_shape: tuple, axes: tuple,
                      tol: float, free: int, wall: float) -> list:
    """(s)'s or (t)'s holds on the world's `ranks` against the witness `w`;
    returns the ranks' kernel launch counts."""
    from repro_torch.launch.mesh import choose_transport, rank_devices

    arch_key, cfg, want = w["key"], w["cfg"], w["want"]
    weight_bytes, peak = w["weight_bytes"], w["peak"]
    b, p, steps = tp_serve_config(arch_key)[1]
    transport = choose_transport(rank_devices(math.prod(mesh_shape), dev))
    errs, agree, clear = [], [], []
    for r in ranks:
        got = [r["prefill"]] + r["logits"]
        ref = [want["prefill"][r["rows"]]] + [w[r["rows"]] for w in want["logits"]]
        errs.append(max(float(np.abs(g - w).max()) for g, w in zip(got, ref)))
        for g, w in zip(got[:-1], ref[:-1]):
            top2 = np.sort(w, axis=-1)[:, -2:]
            ok = g.argmax(-1) == w.argmax(-1)
            agree.append(bool(ok.all()))
            clear.append(bool(ok[(top2[:, 1] - top2[:, 0]) > tol].all()))
    step_bytes = sorted({tuple(sorted((k, v) for k, v in x.items() if v)) for r in ranks
                         for x in r["bytes"]})
    tag = "s" if arch_key == "s" else "t"
    print(f"lm tp ({tag}) {cfg.name}: serving on {dict(zip(axes, mesh_shape))} on {dev} "
          f"({transport}), batch {b}, prompt {p} under the prefill rules, {steps} decode steps "
          f"under decode_32k's (kv_seq -> model), teacher-forced: prefill s "
          f"{[round(r['prefill_ms'] / 1e3, 4) for r in ranks]} (ranks), "
          f"{want['prefill_ms'] / 1e3:.4f} (one device); the caches resharded in "
          f"{[round(r['reshard_ms'], 1) for r in ranks]} ms moving "
          f"{[{k: v for k, v in r['reshard_bytes'].items() if v} for r in ranks][0]} bytes a rank; "
          f"decode ms a step, median {[round(statistics.median(r['ms']), 4) for r in ranks]} "
          f"(ranks), {statistics.median(want['ms']):.4f} (one device; CUDA events, synchronized a "
          f"step); collective bytes a decode step a rank {step_bytes}; weights "
          f"{[r['weight_bytes'] for r in ranks]} bytes a rank of {weight_bytes}, built in "
          f"{[round(r['init_s'], 1) for r in ranks]} s; peak {[r['peak'] for r in ranks]} bytes "
          f"a rank, one device {peak}; {free} bytes free before the spawn; "
          f"{'the world of (r) and (s)' if tag == 's' else 'the world'} {wall:.1f} s; card {card}")
    print(f"lm tp ({tag}): logits against one device: max |diff| "
          f"{[round(e, 5) for e in errs]} by rank (bound {tol}); greedy tokens equal "
          f"{sum(agree)} of {len(agree)} steps and ranks, where the margin passes the bound "
          f"{sum(clear)} of {len(clear)}; dropped choices, prefill: ranks "
          f"{[r['prefill_drops'] for r in ranks]}, one device {want['prefill_drops']}; decode: "
          f"{[r['decode_drops'] for r in ranks]}, {want['decode_drops']}")
    check(max(errs) <= tol, f"lm tp ({tag}): logits {errs} from one device's")
    check(all(clear), f"lm tp ({tag}): a greedy token differs where the margin passes the bound")
    groups = {tuple(r["rows"]): r for r in ranks}  # one rank of each set of rows
    check(sum(r["prefill_drops"] for r in groups.values()) == want["prefill_drops"]
          and all(r["decode_drops"] == 0 for r in ranks) and want["decode_drops"] == 0,
          f"lm tp ({tag}): the drops differ from one device's")
    if arch_key == "t":
        check(all(2 * r["weight_bytes"] <= weight_bytes * 1.01 for r in ranks),
              f"lm tp (t): a rank holds {[r['weight_bytes'] for r in ranks]} of {weight_bytes}")
    return [r["launches"] for r in ranks]


def dry_traces(path: str) -> None:
    """The dry run's work for (u) and (v), on meta tensors on the host (no
    card): every production cell's argument bytes a rank (the blocks'
    shapes), DRY_CELLS through ``launch.dryrun.main`` (the CLI), and the
    train steps of (j), of (r)'s rank 0 and of (i) traced by
    ``launch.trace_cost``, each as the card runs it: (j) and (r) the dry
    run's own cells (``launch.specs.build_train_cell``), (i) its step over
    2 microbatches.  Written to `path` as JSON."""
    import dataclasses
    import io

    from repro_torch.configs.registry import ARCH_IDS, get_arch
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import dryrun, specs, trace_cost
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.config import SHAPES, ShapeConfig
    from repro_torch.train import make_optimizer, make_train_step, warmup_cosine

    out: dict = {"cells": {}, "s": {}}
    t0 = time.perf_counter()
    for multi in (False, True):
        for arch in ARCH_IDS:
            entry = get_arch(arch)
            for shape in SHAPES:
                key = f"{arch}:{shape}:{'multi' if multi else 'single'}"
                try:
                    out["cells"][key] = ("skip" if shape in entry.skip_shapes else dryrun.tree_bytes(
                        specs.build_cell(entry.config, shape, dryrun.production_mesh(multi)).args))
                except Exception as e:  # noqa: BLE001 - reported by (u)
                    out["cells"][key] = f"error: {type(e).__name__}: {e}"
    out["s"]["shapes"] = time.perf_counter() - t0
    cli = Path(path).with_suffix(".jsonl")
    cli.unlink(missing_ok=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        for arch, shape, mesh in DRY_CELLS:
            dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh, "--out", str(cli)])
    out["records"] = [json.loads(line) for line in cli.read_text().splitlines()]
    cli.unlink()
    out["s"]["cli"] = time.perf_counter() - t0

    def traced(key, cfg, shape, mesh=None, microbatches=None):
        t0 = time.perf_counter()
        spec = specs.build_train_cell(cfg, shape, mesh)
        fn = spec.fn
        if microbatches is not None:
            rules = ShardingRules.make(None)
            fn = make_train_step(lambda m, b: T.loss_fn(m.tree(), b, cfg, rules),
                                 make_optimizer("adamw", warmup_cosine(*LM_TRAIN_LR)),
                                 microbatches=microbatches)
        cost = trace_cost.analyze(fn, dryrun.meta_args(spec, shape),
                                  counter=None if mesh is None else mesh.counter)
        out[key] = {"peak": cost.peak_bytes, "flops": cost.flops,
                    "conv_flops": cost.conv_flops, "calls": cost.coll_calls, "bytes": cost.coll_breakdown, "ops": cost.ops,
                    "s": time.perf_counter() - t0}

    b, s, steps = LM_TRAIN_MAMBA
    traced("j", get_arch("mamba2-1.3b").config, ShapeConfig("j", s, b, "train"))
    b, s, _ = LM_TP_TRAIN
    h2o = get_arch(LM_ARCH).config
    traced("r", dataclasses.replace(h2o, remat=LM_TP_REMAT), ShapeConfig("r", s, b, "train"),
           Mesh(dict(zip(("data", "model"), LM_TP_MESH)), 0, torch.device("meta"), "none"))
    b, s, k, _, _ = LM_TRAIN_H2O
    traced("i", h2o, ShapeConfig("i", s, b, "train"), microbatches=k)
    Path(path).write_text(json.dumps(out))


def start_dry_traces():
    """``dry_traces`` in a process of its own, on the host's cores while the
    card runs: (the process, the path it writes)."""
    path = ROOT / "build" / "chip_smoke_dry.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            f"chip_smoke.dry_traces({str(path)!r})")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), path


def dry_results(job) -> dict:
    """The results of ``start_dry_traces``' process, once it has ended."""
    proc, path = job
    t0 = time.perf_counter()
    log, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"the dry run's traces failed: {log[-3000:]}")
    out = json.loads(path.read_text())
    path.unlink()
    out["waited"] = time.perf_counter() - t0
    return out


def lm_tp_dryrun(card: str, dry: dict) -> None:
    """(u): the dry run (``launch.dryrun``): every production cell's
    argument GiB a rank, and DRY_CELLS traced, with the reference's memory
    and roofline columns."""
    cells = {}
    for key, v in dry["cells"].items():
        arch, shape, _ = key.split(":")
        cells.setdefault(f"{arch}:{shape}", []).append(
            round(v / 2**30, 3) if isinstance(v, int) else v)
    print(f"lm tp (u): the dry run's blocks of {len(dry['cells'])} cells in "
          f"{dry['s']['shapes']:.1f} s (no ranks, nothing allocated), argument GiB a rank "
          f"[single, multi]: " + "; ".join(f"{k} {v}" for k, v in cells.items()) + f"; card {card}")
    check(not [k for k, v in dry["cells"].items() if isinstance(v, str) and v != "skip"],
          f"lm tp (u): a cell failed: {dry['cells']}")
    roof_keys = {"flops_per_dev", "hbm_bytes_per_dev", "coll_bytes_per_dev", "coll_breakdown",
                 "model_flops_global", "chips", "compute_s", "memory_s", "collective_s",
                 "dominant", "useful_ratio", "roofline_fraction"}
    for r in dry["records"]:
        mem, roof = r.get("memory", {}), r.get("roofline", {})
        print(f"lm tp (u): {r['arch']} x {r['shape']} x {r['mesh']} traced on meta tensors in "
              f"{r.get('build_s')} s (rank {r.get('rank')}, cache_len {r.get('cache_len')}): "
              f"memory {mem}; dominant {roof.get('dominant')}, terms (c/m/x) "
              f"{[round(roof.get(t, 0) * 1e3, 3) for t in ('compute_s', 'memory_s', 'collective_s')]}"
              f" ms, rf {roof.get('roofline_fraction')}, collective bytes "
              f"{roof.get('coll_breakdown')} (traced counts over H100 SXM data-sheet rates)")
        check(r["status"] == "ok" and set(roof) == roof_keys
              and all(isinstance(mem.get(k), int) for k in ("temp_bytes", "peak_estimate_bytes"))
              and mem["peak_estimate_bytes"] == mem["argument_bytes"] + mem["output_bytes"]
              + mem["temp_bytes"] - mem["alias_bytes"], f"lm tp (u): {r}")
    print(f"lm tp (u): the traced cells' CLI {dry['s']['cli']:.1f} s; the traces' process "
          f"waited for {dry['waited']:.1f} s")


def lm_dry_holds(card: str, dry: dict, h2o_witness: dict, r_ranks: list) -> None:
    """(v): the dry run's traces against this run's card: the traced peak
    of (j) and of a rank of (r) within DRY_PEAK_TOL of the card's
    ``max_memory_allocated``, (r)'s collectives as its ranks counted them
    a step, (i)'s FLOPs as (q)'s ``FlopCounterMode`` counted them."""
    j, r, i = dry["j"], dry["r"], dry["i"]
    j_card = h2o_witness["j_peak"]
    r_card = [x["peak"] for x in r_ranks]
    seen = {(k, st["calls"][k], st["bytes"][k]) for x in r_ranks for st in x["steps"]
            for k in st["calls"]}
    traced = {(k, r["calls"][k], int(r["bytes"][k])) for k in {k for k, _, _ in seen}}
    print(f"lm dry (v): (j) mamba2-1.3b 4 x 4,096 AdamW traced peak {j['peak']} bytes against "
          f"the card's {j_card} ({j['peak'] / j_card - 1:+.2%}; traced in {j['s']:.1f} s, "
          f"{j['ops']} ops); (r) a rank traced {r['peak']} against the ranks' {r_card} "
          f"({[f'{r['peak'] / c - 1:+.2%}' for c in r_card]}; {r['s']:.1f} s); (r)'s "
          f"collectives a step traced {sorted(traced)} against counted {sorted(seen)}; (i)'s "
          f"step traced {i['flops']} FLOPs (+ {i['conv_flops']} of convolutions) "
          f"against (q)'s {h2o_witness['q_flops']} ({i['s']:.1f} s); bound {DRY_PEAK_TOL:.0%}; "
          f"card {card}")
    check(abs(j["peak"] / j_card - 1) <= DRY_PEAK_TOL,
          f"lm dry (v): (j)'s traced peak {j['peak']} against {j_card}")
    check(all(abs(r["peak"] / c - 1) <= DRY_PEAK_TOL for c in r_card),
          f"lm dry (v): (r)'s traced peak {r['peak']} against {r_card}")
    check(traced == seen, f"lm dry (v): (r)'s collectives traced {traced}, counted {seen}")
    check(i["flops"] + i["conv_flops"] == h2o_witness["q_flops"] and i["conv_flops"] == 0,
          f"lm dry (v): (i)'s traced FLOPs {i} against (q)'s {h2o_witness['q_flops']}")


def phase_lm_tp(dev, h2o_witness: dict, dry_job) -> None:
    """The LM's tensor-parallel and FSDP layout (ROADMAP A8): every weight
    the rank's block of the reference's ``param_pspecs``, FSDP weights
    gathered in bf16 as read, column- then row-parallel products over
    ``model``, the vocab-split embedding and cross-entropy, decode's caches
    under ``cache_pspecs``; ranks sharing the card over gloo staged through
    pinned memory, so the times say little of collectives and parity is
    the bar; each witness runs in this process first and is freed before
    the spawn:

    (r) h2o-danube-1.8b training at full width on LM_TP_MESH, LM_TP_TRAIN,
        against the one-device step over the data ranks' rows as
        microbatches: the loss, the gradient norm, every parameter block
        after each step, and the collectives against the layout's count;
    (s) h2o-danube-1.8b serving on LM_TP_MESH: prefill under the prefill
        rules, decode under decode_32k's after a reshard of the caches,
        teacher-forced, the logits within LM_BF16_TOL;
    (t) one jamba-v0.1-52b period on (model=2) under its default rules: the
        dense dispatch of each rank's experts, the SSM split over ``ff``,
        the logits within (f)'s bound, the drops equal, half the weights a
        rank;
    (u) the dry run of every production cell, two of them traced;
    (v) the dry run's traces of (j), (r) and (i) against the card's peaks
        and counts (``lm_dry_holds``).

    (r)'s witness is ``phase_lm_train`` (i)'s first steps (`h2o_witness`,
    the same function); (r) and (s) run in one world of ranks, one after
    the other (one spawn).  None of the eight kernels is launched."""
    from repro_torch.kernels import fused

    from repro_torch.launch.mesh import run_spmd

    t0 = time.perf_counter()
    card = card_line(CARD)
    fused.reset_launches()
    axes = ("data", "model")
    r, s = h2o_witness, lm_tp_serve_witness(dev, "s")
    free, t1 = torch.cuda.mem_get_info()[0], time.perf_counter()
    with HostWatch() as watch:
        ranks = run_spmd(tp_h2o_rank, LM_TP_MESH, axes, device=dev,
                         args=(s["prompts"], s["tokens"]), timeout=900)
    wall = time.perf_counter() - t1
    print(memory_line("lm tp (r), (s)", watch, [x[k]["memory"] for k in "rs" for x in ranks]))
    r_ranks = [x["r"] for x in ranks]
    counts = (lm_tp_train_check(r, r_ranks, dev, card, free, wall)
              + lm_tp_serve_check(s, [x["s"] for x in ranks], dev, card, LM_TP_MESH, axes,
                                  LM_BF16_TOL, free, wall))
    del r, s
    t = lm_tp_serve_witness(dev, "t")
    free, t1 = torch.cuda.mem_get_info()[0], time.perf_counter()
    with HostWatch() as watch:
        ranks = run_spmd(tp_serve_rank, (2,), ("model",), device=dev,
                         args=("t", t["prompts"], t["tokens"]), timeout=900)
    print(memory_line("lm tp (t)", watch, [x["memory"] for x in ranks]))
    counts += lm_tp_serve_check(t, ranks, dev, card, (2,), ("model",),
                                LM_FULL_TOL["jamba-v0.1-52b"], free, time.perf_counter() - t1)
    dry = dry_results(dry_job)
    lm_tp_dryrun(card, dry)
    lm_dry_holds(card, dry, h2o_witness, r_ranks)
    counts.append(dict(fused.LAUNCHES))
    launched = {k: sum(c.get(k, 0) for c in counts) for k in fused.LAUNCHES}
    launched = {k: v for k, v in launched.items() if v}
    check(not launched, f"lm tp: the layout launched {launched}")
    print(f"lm tp: none of the eight kernels launched, by the witnesses or by the "
          f"{len(counts) - 1} rank runs of (r)-(t); {time.perf_counter() - t0:.1f} s in all; "
          f"card {card}")


def lm_profile(fn, top: int = 4):
    """Device busy ms of one call of `fn` (the sum of its kernels' and
    copies' device time, from ``torch.profiler``), their count, and its
    `top` kernels by device time as (name, ms, count).  The profiler
    traces the device alone: a train step's ~10^5 launches took minutes to
    trace with their host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    evs.sort(key=lambda e: -e.device_time_total)
    return (sum(e.device_time_total for e in evs) / 1e3, sum(e.count for e in evs),
            [(e.key[:60], round(e.device_time_total / 1e3, 3), e.count) for e in evs[:top]])


def lm_leaves(tree) -> list:
    return [v for x in tree.values() for v in (lm_leaves(x) if isinstance(x, dict) else [x])]


def phase_examples() -> dict:
    """Two examples on the card as a user runs them: the quickstart and
    ``train_recsys_e2e --steps 40`` (its loss must fall); the third,
    ``presto_vs_disagg``, runs in ``phase_mesh`` (e).  Returns each
    example's launch counts."""
    from repro_torch.examples import quickstart, train_recsys_e2e
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
    card = card_line(CARD)
    print(f"examples: quickstart losses {[round(x, 4) for x in losses]}, launches "
          f"{by_path['quickstart'][1]}; train_recsys_e2e {e2e['params']} parameters, "
          f"{e2e['steps']} steps, loss first {np.mean(e2e['losses'][:k]):.4f} -> last "
          f"{np.mean(e2e['losses'][-k:]):.4f} (mean of {k}), checkpoint step "
          f"{e2e['checkpoint_step']}, launches {by_path['train_recsys_e2e'][1]}; card {card}")
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

    def lib_bytesplit(w):
        f, g, _ = w.shape
        return (w.view(torch.uint8).reshape(f, g, 4, 4).transpose(-1, -2)
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
            library=lambda: lib_bytesplit(dense_w),
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
            bits=True, library=lambda: lib_bytesplit(gen_w), nbytes=gen_w.numel() * 4 * 2,
            ops=nvals(gen_w, 4) * 3, first=gen_w)),
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
              f"library {fmt_ms(row['library_ms'])}, yardstick device "
              f"{fmt_ms(row['yardstick_device_ms'])}, launches {launches}")
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
    card = card_line(CARD)
    dev = torch.device("cuda", 0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    rng = np.random.default_rng(0)
    errs: dict = {}
    laps, last = {}, [t_start]

    def lap(name: str) -> None:  # the seconds since the last lap, charged to `name`
        now = time.perf_counter()
        laps[name], last[0] = round(now - last[0], 1), now

    phase_build()
    lap("build")
    phase_kernels(rng, dev, errs)
    torch.cuda.synchronize()
    lap("kernels")
    phase_standalone_kernels(rng, dev, errs)
    torch.cuda.synchronize()
    lap("standalone kernels")
    engine, store, launches, fused_batches = phase_main_path(dev)
    torch.cuda.synchronize()
    lap("main path")
    bag_rows = phase_embedding(dev, fused_batches[0], errs)
    lap("embedding bag")
    engines, by_path = phase_host_paths(engine.spec, store, fused_batches)
    train_batches = [fused_batches[pid] for pid in range(8)]
    dedup_engines, dedup_by_path, dedup_pages = phase_dedup(dev)
    torch.cuda.synchronize()
    lap("host paths, dedup")
    # the store's files live until the trainer has read them through the service
    files_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    try:
        root = Path(files_dir.name)
        store_by_path = phase_store(dev, engine, fused_batches, root)
        torch.cuda.synchronize()
        lap("store")
        service_by_path = phase_service(engine, root / "classic", fused_batches, root)
        torch.cuda.synchronize()
        lap("service")
        mesh_by_path = phase_mesh(dev, engine.spec, root, fused_batches)
        torch.cuda.synchronize()
        lap("mesh")
        del fused_batches
        phase_train_parity(dev)
        train_by_path = phase_train(dev, train_batches, engine, store, root / "classic")
        lap("train")
    finally:
        files_dir.cleanup()
    del train_batches
    # the checkpoints live under build/ (ignored by git) and go once read
    ckpt_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        driver_by_path = phase_driver(engine, ckpt_root / "driver")
        lap("driver")
        phase_restore(dev, ckpt_root / "driver")
        lap("restore")
        shutil.rmtree(ckpt_root / "driver")
        elastic_launches = phase_elastic(dev, ckpt_root / "elastic")
        lap("elastic")
        shutil.rmtree(ckpt_root / "elastic")
        mesh_elastic_launches = phase_mesh_elastic(dev, ckpt_root / "mesh_elastic")
        lap("mesh elastic")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    example_by_path = phase_examples()
    lap("examples")
    phase_sim()
    lap("sim")
    phase_lm_serve(dev)
    lap("lm serve")
    phase_lm_families(dev)
    lap("lm families")
    # meta tensors traced on the host beside the LM's train steps, which are
    # bound by the card, after every phase whose times move with the host
    dry_job = start_dry_traces()
    atexit.register(lambda: dry_job[0].poll() is None and dry_job[0].kill())
    h2o_witness = phase_lm_train(dev)
    lap("lm train")
    phase_lm_mesh(dev)
    lap("lm mesh")
    phase_lm_tp(dev, h2o_witness, dry_job)
    lap("lm tp")
    by_path = {"presto": launches, **by_path,
               **{f"dedup {name}": by_k for name, by_k in dedup_by_path.items()},
               **store_by_path, **service_by_path, **mesh_by_path, **train_by_path,
               **driver_by_path, "elastic": elastic_launches,
               "mesh elastic": mesh_elastic_launches, **example_by_path}
    totals = {n: sum(path_totals(by_k)[n] for by_k in by_path.values()) for n in launches[1]}
    for name, n in totals.items():
        check(n > 0, f"{name} was never launched")
    print(f"launches: all {len(totals)} kernels launched on the paths ({totals})")
    engines["presto"] = engine
    phase_breakdown(engines, store)
    torch.cuda.synchronize()
    lap("breakdown")
    kernels = phase_timings(engines, store, dev, errs, by_path)
    for row in bag_rows:  # the bag's launches, counted on the paths that train
        row["launches_by_path"] = {path: path_totals(by_k)[row["name"]]
                                   for path, by_k in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    kernels += bag_rows
    for name, e in dedup_engines.items():
        profile_transform(f"dedup {name}", e, dedup_pages)
    torch.cuda.synchronize()
    lap("timings")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s; by phase (s) {laps}")
    print(json.dumps({"kernels": kernels}))
    print(card_line(CARD))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
