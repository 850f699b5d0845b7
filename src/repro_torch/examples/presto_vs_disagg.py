"""PreSto vs Disagg vs Hybrid, side by side: the paper's core comparison
plus the per-family placement the operator-graph IR unlocks.

The port of ``examples/presto_vs_disagg.py``.

1. Kernel level: RM5 geometry, 1,024 rows, one partition's pages on the
   device, the fused ISP path against the multi-pass (one kernel per
   operator) path, each timed with CUDA events on the card (the host clock
   on the CPU), best of ``--reps``.
2. System level: a ``--mesh`` of ranks (default (8, 2), axes data and
   model; on one card the ranks share it) runs ``preprocess_global`` under
   presto, hybrid and disagg, holds each gathered global batch bit for bit
   against the one-device batch, and prints each placement's collective
   and permute bytes per rank from the mesh's counter
   (``distributed.comm``): storage-centric placement moves ZERO bytes
   between Extract and Load; disaggregated placement pays raw-pages-in and
   tensors-out permutes for every column family; hybrid pays them only for
   the families the cost model sends to hosts.

    PYTHONPATH=src python -m repro_torch.examples.presto_vs_disagg [--device cpu] [--mesh 4,2]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.common.util import resolve_device
from repro_torch.core.preprocess import pages_from_partition
from repro_torch.core.presto import TorchPreStoEngine, gather_minibatch
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import RM_CONFIGS, RMDataConfig, SyntheticRecSysSource
from repro_torch.launch.mesh import run_spmd

# the reference's system-level geometry
SYSTEM_CONFIG = RMDataConfig("x", 16, 8, 4, 8, 4, 64, 1 << 20, 100000, rows_per_partition=2048)
SYSTEM_PLACEMENTS = ("presto", "hybrid", "disagg")


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


def system_rank(mesh) -> dict:
    """One rank of the system level: partition 0 under each placement,
    with the mesh's counter read around each global batch; the gathered
    global batch must equal the one-device batch bit for bit."""
    src = SyntheticRecSysSource(SYSTEM_CONFIG, rows=SYSTEM_CONFIG.rows_per_partition)
    spec = TransformSpec.from_source(src)
    store = PartitionedStore(1, 1, src)
    want = TorchPreStoEngine(spec, device=mesh.device).produce_batch(store, 0)
    out = {"transport": mesh.transport, "coords": mesh.coords}
    for placement in SYSTEM_PLACEMENTS:
        engine = TorchPreStoEngine(spec, mesh, placement=placement)
        mesh.counter.reset()
        local = engine.produce_batch(store, 0)
        out[placement] = {"bytes": dict(mesh.counter.bytes), "calls": mesh.counter.total_calls,
                          "host_families": engine.host_families()}
        for key, v in gather_minibatch(local, mesh).items():
            bits = (lambda t: t.view(torch.int32)) if v.dtype == torch.float32 else (lambda t: t)
            if not torch.equal(bits(v), bits(want[key])):
                raise RuntimeError(f"{placement}: the global batch's {key} differs from the "
                                   f"one-device batch")
    return out


def system_level(device: torch.device, shape=(8, 2)) -> list:
    """Per-placement collective bytes per rank over a `shape` mesh."""
    print(f"=== system level ({shape[0]} x {shape[1]} mesh of ranks, "
          f"{SYSTEM_CONFIG.rows_per_partition} rows, per-rank counters) ===")
    ranks = run_spmd(system_rank, shape, ("data", "model"), device=device)
    print(f"ranks on {device.type}, transport {ranks[0]['transport']}")
    for placement in SYSTEM_PLACEMENTS:
        per_rank = [r[placement]["bytes"] for r in ranks]
        coll = sorted({sum(b.values()) for b in per_rank})
        permute = sorted({b["collective-permute"] for b in per_rank})
        host = ",".join(ranks[0][placement]["host_families"]) or "-"
        print(f"{placement:7s}: collective bytes per rank = "
              f"{'/'.join(f'{c / 1e3:.1f}' for c in coll)} KB "
              f"(permute={'/'.join(f'{p / 1e3:.1f}' for p in permute)} KB, "
              f"host families: {host})")
    print("(presto=0: preprocessing collocated with the consuming rank, the "
          "paper's in-storage placement, Fig. 8; hybrid moves only its "
          "host-placed families' bytes)")
    return ranks


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default CUDA)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--mesh", default="8,2", help="data,model ranks of the system level")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = kernel_level(device, args.reps)
    shape = tuple(int(n) for n in args.mesh.split(","))
    out["system"] = system_level(device, shape)
    return out


if __name__ == "__main__":
    main()
