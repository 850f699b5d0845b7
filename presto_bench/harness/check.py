"""What decides ``correct``: the program's outputs held against the plain
reference (``presto_bench/reference``), one number for each comparison,
each against the limit in the cell's ``workloads/<cell>.json``.

- ``batch_ids``: elements of the checked batches whose ids, lengths or
  label bits differ from the reference Transform's (a batch of another
  shape counts every element); exact, so its limit is 0.
- ``batch_dense``: the largest relative error of a Log-normalised dense
  value, |program - reference| / max(|reference|, 1e-6).
- ``loss`` (train cells): the largest relative gap of a checked step's loss.
- ``grad``: by the worst leaf, the gap between the program's and the
  reference's norm of the first step's clipped gradient, over the larger of
  the reference's norm of that leaf and of the median leaf.
- ``update``: the same of each leaf's change after the checked steps,
  leaving out leaves whose first raw gradient in the reference is under a
  thousandth of the median leaf's (such a leaf moves by round-off alone).
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from presto_bench.harness.common import log
from presto_bench.reference import transform as ref_transform

INT_KEYS = ("multi_hot_ids", "lengths", "one_hot_ids")
DENSE_FLOOR = 1e-6
NOUGHT = 1e-3


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def batch_numbers(kept, raw_of: Callable[[int], Dict], params: Dict) -> Dict:
    """``batch_ids`` and ``batch_dense`` over `kept`, a list of (file index,
    batch) pairs, against the reference Transform of each file's raw
    features (``raw_of(file)``)."""
    refs: Dict[int, Dict] = {}
    bad, worst = 0, 0.0
    for fid, batch in kept:
        if fid not in refs:
            refs[fid] = ref_transform.transform(raw_of(fid), params)
        ref = refs[fid]
        for key in INT_KEYS + ("labels",):
            got, want = _np(batch[key]), ref[key]
            if got.shape != want.shape:
                bad += want.size
                continue
            if key == "labels":
                got = got.astype(np.float32).view(np.int32)
                want = want.astype(np.float32).view(np.int32)
            bad += int(np.count_nonzero(got != want))
        got, want = _np(batch["dense"]), ref["dense"]
        if got.shape != want.shape:
            bad += want.size
            worst = math.inf
            continue
        err = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), DENSE_FLOOR)
        worst = max(worst, float(np.nanmax(err)) if err.size else 0.0)
        if np.isnan(err).any():
            worst = math.inf
    return {"batch_ids": bad, "batch_dense": worst}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leave_out=()) -> Dict[str, float]:
    """|program - reference| over max(reference, median), by leaf."""
    keys = [k for k in reference if k not in leave_out]
    med = statistics.median(reference[k] for k in keys) if keys else 0.0
    out = {}
    for k in keys:
        got = program.get(k, math.nan)
        den = max(reference[k], med)
        if not math.isfinite(got):
            out[k] = math.inf
        elif den > 0:
            out[k] = abs(got - reference[k]) / den
        else:
            out[k] = 0.0 if got == reference[k] else math.inf
    return out


def worst_leaf(program: Dict[str, float], reference: Dict[str, float],
               leave_out=()) -> float:
    """The largest of ``leaf_gaps`` (inf where no leaf is left)."""
    gaps = leaf_gaps(program, reference, leave_out)
    return max(gaps.values()) if gaps else math.inf


def nought_leaves(grad_raw: Dict[str, float]) -> List[str]:
    """Leaves whose raw first gradient is under NOUGHT x the median leaf's."""
    med = statistics.median(grad_raw.values())
    return sorted(k for k, v in grad_raw.items() if v < NOUGHT * med)


def train_gaps(losses: List[float], grad: Dict[str, float], change: Dict[str, float],
               ref: Dict) -> Dict:
    """``loss``, ``grad`` and ``update`` of one side against the reference's
    replay (``reference.dlrm.replay``)."""
    loss = max((abs(a - b) / abs(b) if b else math.inf)
               for a, b in zip(losses, ref["loss"])) if losses else math.inf
    if len(losses) != len(ref["loss"]):
        loss = math.inf
    return {"loss": loss, "grad": worst_leaf(grad, ref["grad"]),
            "update": worst_leaf(change, ref["change"], nought_leaves(ref["grad_raw"]))}


def reference_batches(raw_of: Callable[[int], Dict], params: Dict, files: List[int],
                      device) -> List[Dict[str, torch.Tensor]]:
    """The reference Transform's batches of `files`, as tensors on `device`."""
    out = []
    for fid in files:
        b = ref_transform.transform(raw_of(fid), params)
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in b.items()})
    return out


def train_numbers(run, cfg: Dict, data: Dict, params: Dict, kept,
                  losses: List[float], grad: Dict, change: Dict) -> Tuple[Dict, Dict]:
    """Every number of a train cell (the module's list), and the
    reference's replay (``reference.dlrm.replay``)."""
    from presto_bench.reference import dlrm

    n_files = run.traffic["files"]
    kept = [(None if pid is None else pid % n_files, b) for pid, b in kept]
    numbers = batch_numbers([(f, b) for f, b in kept if f is not None], run.partitions.raw,
                            params)
    if any(f is None for f, _ in kept):
        numbers["batch_ids"] = math.inf
    files = [f for f, _ in kept[:len(losses)]]
    batches = reference_batches(run.partitions.raw, params, files, run.device)
    ref = dlrm.replay(cfg["model"], data, cfg["train"], run.seed, batches, run.device)
    numbers.update(train_gaps(losses, grad, change, ref))
    for name, prog, want, out in (("grad", grad, ref["grad"], ()),
                                  ("update", change, ref["change"],
                                   nought_leaves(ref["grad_raw"]))):
        gaps = leaf_gaps(prog, want, out)
        top = sorted(gaps, key=lambda k: -gaps[k])[:3]
        log(f"{name}: worst leaves " + "; ".join(
            f"{k} {gaps[k]:.3e} (program {prog.get(k)!r}, reference {want[k]!r})" for k in top)
            + f"; left out {list(out)}")
    log(f"loss: program {losses}, reference {ref['loss']}")
    return numbers, ref


def verdict(numbers: Dict, limits: Dict) -> Dict:
    """Each number beside its limit, and whether every one holds (a number
    with no limit fails)."""
    rows = {}
    ok = True
    for name, value in numbers.items():
        limit: Optional[float] = limits.get(name)
        holds = limit is not None and math.isfinite(value) and value <= limit
        ok = ok and holds
        rows[name] = {"value": value, "limit": limit}
    return {"correct": ok and bool(numbers), "checks": rows}
