"""One run of one cell, from the manifest's names to the result line's
object.

A cell's traffic file names its driver: ``"driver": "<name>"`` runs
``traffic/<name>.py``'s ``run(run)``, found by name as the metric readers
are (``metrics/<name>.py``), so that a cell of another kind is files added,
not a file edited.  A driver sets up the program, runs the window (and with
``--trace 1`` the traced stretches), and returns the readers' context
(``ctx``), the compared numbers, the peak of device memory and the counts
of attempted and failed units."""

from __future__ import annotations

import importlib.util
import sys
from types import ModuleType
from typing import Dict, Optional

import torch

from presto_bench.harness import check, inputs
from presto_bench.harness.common import Run, device_info, finite, read_metrics
from presto_bench.harness.files import BENCH, cell_files, manifest, metrics_for


def driver(name: str) -> ModuleType:
    """``traffic/<name>.py``, loaded once a process."""
    key = f"presto_bench_driver_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, BENCH / "traffic" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, *, bench: Optional[Dict] = None, files: Optional[Dict] = None,
             partitions=None, processes: int = 1) -> Dict:
    """Run `cell` once and return the result: ``correct``, ``attempted``,
    ``failed``, ``metrics`` (the end-to-end ones, or with `trace` the
    per-layer ones), ``device``, with `trace` the ``breakdown``, and last
    ``checks``, each compared number beside its limit.  `files` replaces the
    cell's configuration, traffic and limits files (the tests' small
    shapes).  `partitions` is the cell's pool of partitions if already
    started (``inputs.start``); it is closed here."""
    bench = bench or manifest()
    entry = next(c for c in bench["workloads"] if c["name"] == cell)
    files = files or cell_files(entry)
    if partitions is None:
        partitions = inputs.start(files, seed, processes)
    run = Run(cell=cell, cfg=files["cfg"], traffic=files["traffic"], limits=files["limits"],
              seed=seed, seconds=seconds, trace=trace, device=device, t_start=t_start,
              partitions=partitions)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    try:
        out = driver(run.traffic["driver"]).run(run)
    finally:
        partitions.close()
    ctx = out["ctx"]
    dev = device_info(device, out["memory_peak_bytes"])
    breakdown = None
    if trace:
        tv = ctx["trace"]
        if tv is None or not tv.device:
            raise RuntimeError("the profiler saw no device operation in the traced stretch")
        dev["busy_s"] = tv.busy_s()
        dev["window_s"] = ctx["trace_window_s"]
        breakdown = {"device_ops": tv.top_ops(10),
                     "idle_gaps": ctx["trace_ranges"].idle_gaps(10)}
    verdict = check.verdict(out["numbers"], run.limits)
    result = {"correct": verdict["correct"], "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": read_metrics(metrics_for(bench, cell, trace), ctx), "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict["checks"]
    return finite(result)
