"""Per-rank dry run of every (arch x shape x mesh) cell: the port of
``repro.launch.dryrun``.

For each cell it builds one rank's ``LoweringSpec`` (``launch.specs``) on
the production mesh (16 x 16 single-pod, 2 x 16 x 16 multi-pod) and records
what that rank holds: it runs no ranks, starts no world and allocates
nothing (the mesh is a ``launch.mesh.Mesh`` record with no process group).
The layout it reports is the one the port runs on a mesh: the reference's
``param_pspecs``, ``opt_state_pspecs`` and ``cache_pspecs`` under the
shape's rules, every block even (a sharded axis that does not divide
raises, as the reference's ``NamedSharding`` does, and the cell is an
error).  Every rank's blocks then have one shape, so rank 0 answers for
all.

A record is one JSON line with the reference's keys: ``arch``, ``shape``,
``mesh``, ``status`` (ok, skip or error) and ``reason``; an ok cell adds
``chips`` and

* ``memory``: ``argument_bytes`` (the rank's inputs), ``output_bytes``
  (its outputs: the new state and metrics of a train step, the logits and
  caches of prefill and decode, the encoder's output of an enc-dec
  prefill), ``alias_bytes`` (the outputs updated in place: a train step's
  state, a decode step's caches) and ``temp_bytes``, null: there is no
  compiler to estimate temporaries (``chip_smoke.py``'s mesh phases
  measure real peaks);
* ``roofline``: the compute term of ``roofline.model_flops`` (6 N D for
  training, 2 N D for inference, active parameters) over the chips at the
  H100's bf16 dense rate, marked as a model count, not a compiled one.

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
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES

METRIC_KEYS = ("loss", "xent", "grad_norm", "lr")  # a train step's f32 scalar metrics


def production_mesh(multi_pod: bool, rank: int = 0) -> Mesh:
    """Rank `rank`'s view of the production mesh, with no world behind it."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    return Mesh(shape, rank, torch.device("meta"), "none")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)) and not isinstance(tree, ShapeDtype):
        return sum(tree_bytes(v) for v in tree)
    return math.prod(tree.shape) * torch.empty((), dtype=tree.dtype).element_size()


def output_bytes(cfg, shape, spec) -> tuple:
    """(output bytes, of which updated in place) of one rank's cell."""
    rules = spec.rules
    if shape.kind == "train":
        state = tree_bytes(spec.args[0])
        n_metrics = len(METRIC_KEYS) + (0 if cfg.is_encdec else 1)  # and moe_aux
        return state + 4 * n_metrics, state
    rows = spec.args[1].shape[0]
    dt = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    if shape.kind == "prefill" and cfg.is_encdec:
        return tree_bytes(spec.args[1]), 0
    vocab = cfg.padded_vocab // max(rules.axis_size("vocab"), 1)
    logits = rows * vocab * dt
    if shape.kind == "decode":
        caches = tree_bytes(spec.args[2])
        return logits + caches, caches
    caches = T.cache_block_shapes(cfg, rows, shape.seq_len, rules)
    flat = []

    def walk(node):
        for v in node.values():
            walk(v) if isinstance(v, dict) else flat.append(ShapeDtype(*v))

    walk(caches)
    return logits + tree_bytes(flat), 0


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
        mesh = production_mesh(multi_pod)
        chips = math.prod(mesh.shape.values())
        shape = SHAPES[shape_name]
        spec = build_cell(cfg, shape_name, mesh)
        args = tree_bytes(spec.args)
        out, alias = output_bytes(cfg, shape, spec)
        flops = rl.model_flops(cfg, shape)
        rec.update(
            status="ok",
            build_s=round(time.time() - t0, 3),
            chips=chips,
            memory={"argument_bytes": args, "output_bytes": out, "alias_bytes": alias,
                    "temp_bytes": None},
            roofline={"model_flops": flops, "flops_per_chip": flops / chips,
                      "compute_s": flops / chips / rl.PEAK_FLOPS,
                      "flops_source": "model count (roofline.model_flops), not compiled"},
        )
        print(f"[ok] {arch_id} x {shape_name} x {mesh_name}: args/rank {args / 2**30:.3f} GiB, "
              f"outputs/rank {out / 2**30:.3f} GiB, compute "
              f"{rec['roofline']['compute_s'] * 1e3:.2f} ms (model FLOPs)", flush=True)
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
    ap.add_argument("--reduced", action="store_true", help="smoke-size configs")
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
