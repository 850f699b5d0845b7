"""The readings that the limits of ``workloads/<cell>.json`` are set from,
on the card, at the cell's own size, in one process:

    python3 presto_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        --control-seeds 1 2 3 --seconds 3

For every seed it runs the cell as ``run.py`` does (a short window) and
prints the program's compared numbers; for each control seed it also prints
the control's and, in a train cell, the planted fault's readings
(``harness/control.py``).  One JSON line per reading.
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
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from presto_bench.harness import control, files, inputs
    from presto_bench.harness.cells import run_cell

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = files.manifest()
    entry = next(c for c in bench["workloads"] if c["name"] == args.workload)
    cf = files.cell_files(entry)
    data = inputs.data_config(cf["cfg"], cf["traffic"])
    procs = min(8, os.cpu_count() or 1)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, device, t0, bench=bench,
                     files=cf, processes=procs)
        print(json.dumps({"seed": seed, "side": "program", "correct": r["correct"],
                          "numbers": {k: v["value"] for k, v in r["checks"].items()},
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()}}),
              flush=True)
        if seed not in args.control_seeds:
            continue
        _, params = inputs.transform_spec(data, seed)
        def raw_of(f, seed=seed):
            return inputs.raw_partition(data, seed, f)

        print(json.dumps({"seed": seed, "side": "control_transform",
                          "numbers": control.transform_control(raw_of, params, [0, 1])}),
              flush=True)
        if cf["traffic"]["driver"] == "train":
            got = control.train_control(cf["cfg"], data, seed, raw_of, params, [0, 1, 2], device)
            for side, numbers in got.items():
                print(json.dumps({"seed": seed, "side": side, "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
