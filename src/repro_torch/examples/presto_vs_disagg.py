"""PreSto vs Disagg at the kernel level: the fused ISP path against the
multi-pass (one kernel per operator) path.

The port of ``examples/presto_vs_disagg.py``'s kernel level: RM5
geometry, 1,024 rows, one partition's pages on the device, each plan timed
with CUDA events on the card (the host clock on the CPU), best of
``--reps``.  The reference's system level (the compiled collective bytes
of presto, hybrid and disagg over a 16-device mesh) waits for the port's
meshed ``preprocess_global`` and an HLO-cost counterpart; this script
prints no figure in its place.

    PYTHONPATH=src python -m repro_torch.examples.presto_vs_disagg [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.common.util import resolve_device
from repro_torch.core.preprocess import pages_from_partition
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.synth import RM_CONFIGS, SyntheticRecSysSource


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Best of `reps` calls of fn, in ms: CUDA events on the card, the host
    clock on the CPU."""
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def kernel_level(device: torch.device, reps: int = 10) -> dict:
    print("=== kernel level (RM5 geometry, 1024 rows) ===")
    src = SyntheticRecSysSource(RM_CONFIGS["rm5"], rows=1024)
    spec = TransformSpec.from_source(src)
    engines = {mode: TorchPreStoEngine(spec, kernel_mode=mode, device=device)
               for mode in ("fused", "unfused")}
    fused = engines["fused"]
    pages = fused.put_pages(fused.pin_pages(pages_from_partition(src.partition(0), spec)))
    out = {}
    for mode, engine in engines.items():
        engine.preprocess_local(pages)  # warm-up: builds the kernels on first use
        out[mode] = time_ms(lambda e=engine: e.preprocess_local(pages), device, reps)
    tf, tu = out["fused"], out["unfused"]
    print(f"unfused (Disagg-style multi-pass): {tu:.3f} ms/partition")
    print(f"fused   (PreSto ISP pipeline):     {tf:.3f} ms/partition -> {tu/tf:.2f}x")
    return {"fused_ms": tf, "unfused_ms": tu}


def system_level() -> None:
    print("=== system level: waits for the port's meshed preprocess_global and an "
          "HLO-cost counterpart (no figure) ===")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default CUDA)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    out = kernel_level(resolve_device(args.device), args.reps)
    system_level()
    return out


if __name__ == "__main__":
    main()
