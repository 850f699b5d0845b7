"""A second witness for a train cell's ``grad`` number: the first step's
clipped gradient, leaf by leaf, in float64, beside the program's and the
float32 reference's, on the card at the cell's own size:

    python3 presto_bench/witness.py --workload rm2-train-fed --seeds 1 2 3 --seconds 2

For every seed it runs the cell as ``run.py`` does (a short window), keeps
the program's and the reference's norms of each leaf's first clipped
gradient, then replays step 1 in float64 on the reference Transform's batch
and the drawn weights, each table cut to the rows the batch looks up (the
other rows' gradient is zero).  It prints one JSON line a seed: each side's
worst gap to float64 (by the check's measure, over the larger of the
float64 norm of the leaf and of the median leaf), and the leaves where the
program and the reference part most, with the three norms.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
for _p in (_ROOT / "src", _ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def float64_grad_norms(model, data, train, seed, batch, device):
    """Each leaf's norm of step 1's clipped gradient, in float64."""
    import torch

    from presto_bench.reference import dlrm, draw

    s, rows = data["n_sparse"], data["embedding_rows"]
    ids = batch["multi_hot_ids"].long().clone()
    one = batch["one_hot_ids"].long().clone()
    p = {}
    for name, shape, std, idx in draw.leaf_specs(model, data):
        w = draw.draw_leaf(shape, std, idx, seed, device)
        if name.startswith("tables."):
            t = int(name.split(".")[1])
            tid = ids[:, t, :] if t < s else one[:, t - s]
            valid = (tid >= 0) & (tid < rows)
            used, inv = torch.unique(tid.clamp(0, rows - 1), return_inverse=True)
            w = w[used]
            tid.copy_(torch.where(valid, inv, torch.full_like(inv, -1)))
        p[name] = w.double().requires_grad_(True)
        del w
    b = {"dense": batch["dense"].double(), "multi_hot_ids": ids, "one_hot_ids": one,
         "lengths": batch["lengths"], "labels": batch["labels"].double()}
    with dlrm.matmul_precision(False):
        loss = dlrm.bce(dlrm.forward(p, b, model, data), b["labels"])
        grads = torch.autograd.grad(loss, list(p.values()))
    sq = sum(float(torch.sum(g * g)) for g in grads)
    scale = min(1.0, train["clip_norm"] / max(math.sqrt(sq), 1e-9))
    return {name: float(torch.linalg.vector_norm(g)) * scale for name, g in zip(p, grads)}


def gaps_to(side, truth):
    """|side - truth| over max(truth, median of truth), by leaf."""
    import statistics

    med = statistics.median(truth.values())
    return {k: abs(side[k] - truth[k]) / max(truth[k], med) for k in truth}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from presto_bench.harness import cells, check, common, files, inputs

    if not torch.cuda.is_available():
        print("witness.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = files.manifest()
    entry = next(c for c in bench["workloads"] if c["name"] == args.workload)
    cf = files.cell_files(entry)
    data = inputs.data_config(cf["cfg"], cf["traffic"])
    for seed in args.seeds:
        partitions = inputs.start(cf, seed, min(8, os.cpu_count() or 1))
        run = common.Run(cell=args.workload, cfg=cf["cfg"], traffic=cf["traffic"],
                         limits=cf["limits"], seed=seed, seconds=args.seconds, trace=False,
                         device=device, t_start=time.perf_counter(), partitions=partitions)
        try:
            out = cells.driver(cf["traffic"]["driver"]).run(run)
        finally:
            partitions.close()
        detail = out["detail"]
        prog, ref = detail["grad"], detail["reference"]["grad"]
        torch.cuda.empty_cache()
        _, params = inputs.transform_spec(data, seed)
        batch = check.reference_batches(partitions.raw, params, detail["files"][:1], device)[0]
        f64 = float64_grad_norms(cf["cfg"]["model"], data, cf["cfg"]["train"], seed, batch,
                                 device)
        del batch
        torch.cuda.empty_cache()
        g_prog, g_ref = gaps_to(prog, f64), gaps_to(ref, f64)
        apart = check.leaf_gaps(prog, ref)
        top = sorted(apart, key=lambda k: -apart[k])[:5]
        print(json.dumps({
            "seed": seed, "grad": out["numbers"]["grad"],
            "program_to_float64": max(g_prog.values()),
            "program_worst_leaf": max(g_prog, key=g_prog.get),
            "reference_to_float64": max(g_ref.values()),
            "reference_worst_leaf": max(g_ref, key=g_ref.get),
            "apart": [{"leaf": k, "program_reference": apart[k], "program_float64": g_prog[k],
                       "reference_float64": g_ref[k], "program": prog[k], "reference": ref[k],
                       "float64": f64[k]} for k in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
