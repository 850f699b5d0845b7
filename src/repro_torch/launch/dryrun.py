"""Per-rank dry run of every (arch x shape x mesh) cell: the port of
``repro.launch.dryrun``.

For each cell it builds one rank's ``LoweringSpec`` (``launch.specs``) on
the production mesh (16 x 16 single-pod, 2 x 16 x 16 multi-pod; under
``--reduced`` the smoke-size configs on 2 x 2 and 2 x 2 x 2, which their
4 to 8 heads, experts and SSM heads divide, where 16 ranks do not) and traces
that rank's step once on meta tensors (``launch.trace_cost``): it runs no
ranks, starts no world and allocates nothing.  The mesh is a
``launch.mesh.Mesh`` record with no process group, whose collectives
(``distributed.comm``) count their bytes and move nothing.  The layout is
the one the port runs on a mesh: the reference's ``param_pspecs``,
``opt_state_pspecs`` and ``cache_pspecs`` under the shape's rules, every
block even (a sharded axis that does not divide raises, as the
reference's ``NamedSharding`` does, and the cell is an error).  Every
rank's blocks have one shape, so rank 0's trace answers for all but what
depends on a rank's coordinates: a decode step is traced at a concrete
``cache_len`` (the cache's last position, ``seq_len - 1``), and under
context-parallel decode only the rank whose slice holds that position
writes the token's k and v; the record names its rank and its length.

A record is one JSON line with the reference's keys: ``arch``, ``shape``,
``mesh``, ``status`` (ok, skip or error) and ``reason``; an ok cell adds
``build_s`` (the spec and the trace, seconds), ``chips``, ``rank``,
``cache_len`` (decode) and

* ``memory``: ``argument_bytes`` (the rank's inputs), ``output_bytes``
  (its outputs, each storage once), ``alias_bytes`` (the outputs that are
  inputs updated in place: a train step's parameters and optimizer state,
  a decode step's caches), ``peak_estimate_bytes`` (the trace's peak of
  live storages on the rank's card, rounded to the allocator's 512-byte
  blocks) and ``temp_bytes`` = peak - arguments - outputs + aliases, so
  that the reference's ``peak = args + out + temp - alias`` holds;
* ``roofline``: ``roofline.from_cost``'s terms (``to_json``): FLOPs, HBM
  bytes and collective bytes by kind a rank, the model FLOPs, each term's
  seconds at the H100 SXM data-sheet rates, the dominant term and the
  roofline fraction.  They are traced counts over data-sheet rates, not
  measurements;
* ``cost``: what the trace counts beside them: transcendentals,
  convolution FLOPs, collective calls by kind and ops dispatched.

Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out build/dryrun.jsonl
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.common.util import ShapeDtype
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch import roofline as rl
from repro_torch.launch import trace_cost
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models.config import SHAPES
from repro_torch.models.layers import ParamTree


def production_mesh(multi_pod: bool, rank: int = 0, reduced: bool = False) -> Mesh:
    """Rank `rank`'s view of the production mesh, with no world behind it;
    `reduced`, of the (2, 2) mesh (2 x 2 x 2 multi-pod) that the reduced
    configs' heads, experts and SSM heads divide (16 ranks do not)."""
    n = 2 if reduced else 16
    shape = {"pod": 2, "data": n, "model": n} if multi_pod else {"data": n, "model": n}
    return Mesh(shape, rank, torch.device("meta"), "none")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)) and not isinstance(tree, ShapeDtype):
        return sum(tree_bytes(v) for v in tree)
    return math.prod(tree.shape) * torch.empty((), dtype=tree.dtype).element_size()


def meta_args(spec, shape) -> list:
    """`spec.args` as meta tensors: a train cell's parameters as the
    ``ParamTree`` the step takes, a decode cell's length as the concrete
    ``shape.seq_len - 1`` (``decode_step`` reads it on the host)."""

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and not isinstance(tree, ShapeDtype):
            return tuple(meta(v) for v in tree)
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")

    args = list(meta(spec.args))
    if shape.kind == "train":
        args[0] = dict(args[0], params=ParamTree(args[0]["params"]))
    if shape.kind == "decode":
        args[3] = shape.seq_len - 1
    return args


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, out_path: str,
             reduced: bool = False) -> dict:
    entry = get_arch(arch_id)
    cfg = entry.reduced if reduced else entry.config
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name, "status": "skip",
           "reason": ""}
    if shape_name in entry.skip_shapes:
        rec["reason"] = "inapplicable (see DESIGN.md SArch-applicability)"
        _emit(rec, out_path)
        return rec
    t0 = time.time()
    try:
        mesh = production_mesh(multi_pod, reduced=reduced)
        chips = math.prod(mesh.shape.values())
        shape = SHAPES[shape_name]
        spec = build_cell(cfg, shape_name, mesh)
        args = meta_args(spec, shape)
        cost = trace_cost.analyze(spec.fn, args, counter=mesh.counter)
        terms = rl.from_cost(cost, cfg, shape, chips)
        arg_bytes = tree_bytes(spec.args)
        temp = cost.peak_bytes - arg_bytes - cost.out_bytes + cost.alias_bytes
        rec.update(
            status="ok",
            build_s=round(time.time() - t0, 3),
            chips=chips,
            rank=mesh.rank,
            memory={"argument_bytes": arg_bytes, "output_bytes": cost.out_bytes,
                    "alias_bytes": cost.alias_bytes, "temp_bytes": temp,
                    "peak_estimate_bytes": cost.peak_bytes},
            roofline=terms.to_json(),
            cost={"trans": cost.trans, "conv_flops": cost.conv_flops,
                  "coll_calls": cost.coll_calls, "ops": cost.ops},
        )
        if shape.kind == "decode":
            rec["cache_len"] = args[3]
        print(f"[ok] {arch_id} x {shape_name} x {mesh_name}: traced in {rec['build_s']}s, "
              f"temp/rank {temp / 2**30:.2f} GiB, args/rank {arg_bytes / 2**30:.2f} GiB, "
              f"peak/rank {cost.peak_bytes / 2**30:.2f} GiB, dominant={terms.dominant}, "
              f"terms(c/m/x)=({terms.compute_s * 1e3:.2f}/{terms.memory_s * 1e3:.2f}/"
              f"{terms.collective_s * 1e3:.2f})ms, rf={terms.roofline_fraction:.3f}",
              flush=True)
    except Exception as e:  # noqa: BLE001 - record, continue the sweep
        rec.update(status="error", reason=f"{type(e).__name__}: {e}",
                   build_s=round(time.time() - t0, 3))
        print(f"[ERR] {arch_id} x {shape_name} x {mesh_name}: {rec['reason']}", flush=True)
        traceback.print_exc()
    _emit(rec, out_path)
    return rec


def _emit(rec: dict, out_path: str) -> None:
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun.jsonl")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size configs, on a (2, 2) mesh (2 x 2 x 2 multi-pod)")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already ok in --out")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r["status"] in ("ok", "skip"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    n_ok = n_err = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                if (arch, shape, "multi" if multi else "single") in done:
                    continue
                rec = run_cell(arch, shape, multi, args.out, reduced=args.reduced)
                n_ok += rec["status"] in ("ok", "skip")
                n_err += rec["status"] == "error"
    print(f"dryrun complete: {n_ok} ok/skip, {n_err} errors", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
