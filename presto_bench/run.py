"""The benchmark of the PreSto port (``repro_torch``) on NVIDIA GPUs.

    python3 presto_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` once, from the root of a checkout, and
prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``, each number compared beside its limit,
which also end standard error.  Exits with another code than 0, and prints
no result, where no CUDA card is present or fewer than the cell asks for,
and where a module named ``jax``, ``jaxlib``, ``flax`` or ``repro`` (whole
top-level names) was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
for _p in (_ROOT / "src", _ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from presto_bench.harness import files

    bench = files.manifest()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    cell_files = files.cell_files(cells[args.workload])
    # the partitions are made in other processes while torch loads (two
    # cores left to the loading: with all eight busy it took ~13 s, not ~8)
    from presto_bench.harness import inputs

    partitions = inputs.start(cell_files, args.seed, max(1, min(6, (os.cpu_count() or 1) - 2)))
    try:
        import torch

        chips = cells[args.workload]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {chips} CUDA card(s); found {found}", file=sys.stderr)
            return 2
        from presto_bench.harness.cells import run_cell
        from presto_bench.harness.common import forbidden_loaded, log

        log(f"setup: torch imported, {time.perf_counter() - T_START:.3f} s")
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START, bench=bench, files=cell_files,
                          partitions=partitions)
    finally:
        partitions.close()
    bad = forbidden_loaded()
    if bad:
        print(f"the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
