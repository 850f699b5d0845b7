"""The readings that a cell's limits are set from, besides the program's own:
the control (the reference put in the program's place, one precision below
the configuration's float32) and the planted faults that a train cell can
have.

- ``transform_control``: the reference Transform in bfloat16 against the
  float32 one (``batch_ids``, ``batch_dense``).
- ``train_control``: the reference DLRM and AdamW with TF32 matrix products
  against the plain float32 replay (``loss``, ``grad``, ``update``), and the
  fault of half the batch left out, the mean taken over the rest.  A step
  that returns its state unchanged reads 1 on ``update`` by the measure
  itself and needs no run.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from presto_bench.harness import check
from presto_bench.reference import dlrm
from presto_bench.reference import transform as ref_transform


def transform_control(raw_of: Callable[[int], Dict], params: Dict, files: List[int]) -> Dict:
    kept = [(f, ref_transform.transform(raw_of(f), params, "bfloat16")) for f in files]
    return check.batch_numbers(kept, raw_of, params)


def train_control(cfg: Dict, data: Dict, seed: int, raw_of: Callable[[int], Dict],
                  params: Dict, files: List[int], device) -> Dict:
    batches = check.reference_batches(raw_of, params, files, device)
    ref = dlrm.replay(cfg["model"], data, cfg["train"], seed, batches, device)
    out = {}
    tf32 = dlrm.replay(cfg["model"], data, cfg["train"], seed, batches, device, tf32=True)
    out["control"] = check.train_gaps(tf32["loss"], tf32["grad"], tf32["change"], ref)
    half = dlrm.replay(cfg["model"], data, cfg["train"], seed, batches, device,
                       rows=batches[0]["labels"].shape[0] // 2)
    out["half_batch"] = check.train_gaps(half["loss"], half["grad"], half["change"], ref)
    return out
