"""The ISP driver (``"driver": "isp"``): one PreSto unit's produce loop, the
rate one ISP unit sustains (the paper's Fig. 11).

Set-up makes the traffic's pool of partitions and stages and pins them in
launches of ``megabatch`` partitions (``TorchPreStoEngine.stage_megabatch``
through a ``PartitionedStore`` over them, then ``pin_pages``); nothing is
written to disk.  The window is a closed loop of ``launch`` / ``deliver``
with ``in_flight`` launches outstanding, launching the pool's groups in
turn under the traffic's ``placement``; once ``seconds`` have passed it
launches no more and delivers those in flight, so it ends at a delivery's
sync.  A traced run then profiles ``trace_batches`` more batches of the
same loop.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import torch

from presto_bench.harness import check, inputs
from presto_bench.harness.common import Run, Tracer, log, percentile, steady, sync


def groups(n_files: int, k: int) -> List[List[int]]:
    """The pool's files in launches of `k` (the last group wraps around)."""
    return [[(g + j) % n_files for j in range(k)] for g in range(0, n_files, k)]


def _loop(engine, pinned, traffic, n_batches=None, seconds=None, sample=None, files=()):
    """The closed loop over `pinned`, a list of (files, pinned pages);
    returns the host seconds of each launch, each batch's latency, the
    batches kept as (file, batch): the last one, and those `sample` kept of
    the batches of `files`; the rows delivered, and the host clock at the
    start and at the last delivery."""
    depth, k = traffic["in_flight"], traffic["megabatch"]
    inflight = collections.deque()
    launch_s, latency_s = [], []
    rows, i, last = 0, 0, None
    t0 = t_end = time.perf_counter()

    def more():
        if n_batches is not None:
            return i * k < n_batches
        return time.perf_counter() - t0 < seconds

    while True:
        while len(inflight) < depth and more():
            fids, pages = pinned[i % len(pinned)]
            ta = time.perf_counter()
            batches, done = engine.launch(pages)
            launch_s.append(time.perf_counter() - ta)
            inflight.append((fids, ta, batches, done))
            i += 1
        if not inflight:
            break
        fids, ta, batches, done = inflight.popleft()
        engine.deliver(done)
        t_end = time.perf_counter()
        for fid, batch in zip(fids, batches):
            latency_s.append(t_end - ta)
            rows += int(batch["labels"].shape[0])
            if sample is not None and fid in files:
                sample.offer((fid, batch))
            last = (fid, batch)
    kept = ([] if sample is None else list(sample.items)) + ([last] if last else [])
    return launch_s, latency_s, kept, rows, t0, t_end


def run(run: Run) -> Dict:
    from repro_torch.core.presto import TorchPreStoEngine

    cfg, tr = run.cfg, run.traffic
    data = inputs.data_config(cfg, tr)
    spec, params_np = inputs.transform_spec(data, run.seed)
    store = inputs.memory_store(run.partitions.wait())
    log(f"setup: {tr['files']} partitions made, {time.perf_counter() - run.t_start:.3f} s")
    engine = TorchPreStoEngine(spec, placement=tr["placement"], device=run.device)
    pinned = [(fids, engine.pin_pages(engine.stage_megabatch(store, fids)))
              for fids in groups(tr["files"], tr["megabatch"])]
    log(f"setup: staged and pinned, {time.perf_counter() - run.t_start:.3f} s")
    _loop(engine, pinned, tr, n_batches=tr["warmup_batches"])
    sync(run.device)
    log(f"setup: {tr['warmup_batches']} warm-up batches, {time.perf_counter() - run.t_start:.3f} s")
    sample = inputs.Sample(run.seed, tr["check_window_batches"])
    files = inputs.chosen_files(run.seed, tr["files"], tr["check_files"])
    steady()
    launch_s, latency_s, kept, rows, t0, t_end = _loop(engine, pinned, tr, seconds=run.seconds,
                                                       sample=sample, files=files)
    steady(False)
    n = len(latency_s)
    if n >= 40:  # how far the window's two halves differ, beside the spread between runs
        half = n // 2
        log("window halves: p95 " + ", ".join(
            f"{percentile(part, 95) * 1e3:.4f}" for part in (latency_s[:half], latency_s[half:]))
            + " ms")
    tracer = Tracer(1, run.device, per_unit=tr["trace_batches"])
    while run.trace and tracer.tick():
        _loop(engine, pinned, tr, n_batches=tr["trace_batches"])
    memory_peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    ctx = dict(tracer.ctx(), **{
        "kind": "isp", "setup_s": t0 - run.t_start, "window_s": t_end - t0,
        "units": n, "rows": rows, "latency_s": latency_s, "launch_s": launch_s,
        "data": data, "dup_factor": data["dup_factor"],
    })
    numbers = check.batch_numbers(kept, run.partitions.raw, params_np)
    return {"ctx": ctx, "numbers": numbers, "memory_peak_bytes": memory_peak,
            "attempted": n, "failed": 0}
