"""What every cell shares: the run's settings, the device's clock, the
traced stretches, the metric readers and the result line's parts."""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import math
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from presto_bench.harness import files

# whole top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    cell: str
    cfg: Dict
    traffic: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # host clock at the process's start
    partitions: Any = None  # the traffic's ``inputs.Partitions``


def reader(name: str) -> Callable[[Dict], Optional[float]]:
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = files.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"presto_bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[Dict], ctx: Dict) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def log(msg: str) -> None:
    """A line of the run's account on standard error."""
    print(msg, file=sys.stderr, flush=True)


def steady(on: bool = True) -> None:
    """Before a window (`on`): collect the set-up's garbage and exempt what
    is left from later collections, so that the window's collections stay
    short.  After it: let the collector see those objects again, so that
    the program's state can be freed."""
    if on:
        gc.collect()
        gc.freeze()
    else:
        gc.unfreeze()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """The two traced stretches of a ``--trace 1`` run, after the window,
    each of ``units`` units (steps, or loops of ``per_unit`` batches) after
    one unit of the profiler's warm-up: the first profiles the device alone
    (its busy time, idle share and operations: tracing the host's
    operations too slows the host enough to idle the device), the second
    the host's operations as well (which range launched what, and what the
    host did in the device's gaps).  Call ``tick()`` once the window has
    closed and after every unit; it returns False once both stretches have
    ended.  Each stretch's length is the host clock between device syncs at
    its ends."""

    def __init__(self, units: int, device: torch.device, per_unit: int = 1):
        from torch.profiler import ProfilerActivity

        self.units, self.per_unit, self.device = units, per_unit, device
        self.plans = [("trace", [ProfilerActivity.CUDA]),
                      ("trace_ranges", [ProfilerActivity.CPU, ProfilerActivity.CUDA])]
        self.done: Dict[str, Any] = {}
        self.prof = None

    def _ready(self, prof) -> None:
        self._view = read_trace(prof)

    def tick(self) -> bool:
        from torch.profiler import profile, schedule, supported_activities

        if self.prof is None:
            if len(self.done) == len(self.plans):
                return False
            name, activities = self.plans[len(self.done)]
            if not set(activities) <= set(supported_activities()):  # no device to trace
                from presto_bench.harness.trace import TraceView

                self.done[name] = (TraceView([]), 0.0)
                return self.tick()
            self.prof = profile(activities=activities, on_trace_ready=self._ready,
                                schedule=schedule(wait=0, warmup=1, active=self.units, repeat=1))
            sync(self.device)
            self.prof.start()
            self.count = -1
            return True
        self.count += 1
        sync(self.device)
        if self.count == 0:  # the warm-up unit has ended
            self.prof.step()
            self.t0 = time.perf_counter()
            return True
        if self.count < self.units:
            return True
        window = time.perf_counter() - self.t0
        self.prof.step()  # ends the stretch: ``_ready`` reads its trace
        self.prof.stop()
        self.done[self.plans[len(self.done)][0]] = (self._view, window)
        self.prof = None
        return self.tick()

    def ctx(self) -> Dict:
        """The stretches' traces (``TraceView``) for the metric readers."""
        if not self.done:
            return {}
        out = {"trace_units": self.units * self.per_unit, "trace_window_s": self.done["trace"][1]}
        out.update({name: view for name, (view, _) in self.done.items()})
        return out


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that a run may not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank q-th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def finite(x: Any) -> Any:
    """JSON-safe: a non-finite number becomes 1e30."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e30
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def device_info(device: torch.device, memory_peak: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": memory_peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(memory_peak)}


def read_trace(prof):
    """The stopped profiler's Chrome trace as a ``TraceView`` (written to a
    temporary file, read and deleted)."""
    from presto_bench.harness.trace import TraceView

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return TraceView.load(path)
    finally:
        os.unlink(path)
