"""The benchmark's synthetic RecSys source: raw features at Table I's shapes.

A frozen copy of the draws of the PreSto paper's synthetic RM1-RM5 data
(arXiv:2406.14571, Table I), numpy only, so that a later change to the
program's own generator cannot move the benchmark's inputs.  The same
``(data config, rows, seed, file)`` gives bitwise the same raw partition:

- dense features: lognormal(1, 2), f32;
- sparse (multi-hot) lengths: Poisson(avg_sparse_len) clipped to
  [1, max_sparse_len] (all 1 when max_sparse_len is 1);
- raw ids: a squared uniform over the id space (skewed to small ids),
  scattered by a multiplicative hash; positions beyond a row's length are 0;
- labels: 1 with probability 0.25;
- dedup traffic (``dup_factor`` > 1): every ``dup_factor`` consecutive rows
  form one session that shares one sparse block.

``transform_params`` gives the Transform's parameters for a seed: the sorted
bucket boundaries of each generated feature, the dense column that feeds it,
and the SigridHash seed and table size of every table.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

U32 = np.uint32


def transform_params(data: Dict, seed: int) -> Dict[str, np.ndarray]:
    """The Transform's parameter arrays for dataset `seed`."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    bounds = np.sort(
        rng.lognormal(mean=1.0, sigma=2.0, size=(data["n_generated"], data["bucket_size"]))
        .astype(np.float32),
        axis=-1,
    )
    ns, ng = data["n_sparse"], data["n_generated"]
    with np.errstate(over="ignore"):
        sparse_seeds = np.arange(ns, dtype=U32) * U32(2654435761) + U32(1)
        gen_seeds = np.arange(ng, dtype=U32) * U32(40503) + U32(7)
    return {
        "bucket_boundaries": bounds,
        "generated_source": np.arange(ng, dtype=np.int64) % max(data["n_dense"], 1),
        "sparse_seeds": sparse_seeds,
        "sparse_max": np.full(ns, data["embedding_rows"], U32),
        "gen_seeds": gen_seeds,
        "gen_max": np.full(ng, data["embedding_rows"], U32),
    }


def _sparse_blocks(rng, data: Dict, n: int):
    """n sparse blocks: ((n, S, L) int32 ids, (n, S) int32 lengths)."""
    s, L = data["n_sparse"], data["max_sparse_len"]
    if L == 1:
        lengths = np.ones((n, s), dtype=np.int32)
    else:
        lengths = np.clip(rng.poisson(data["avg_sparse_len"], size=(n, s)), 1, L).astype(np.int32)
    u = rng.random(size=(n, s, L))
    ids = (u * u * (data["id_space"] - 1)).astype(np.int64)
    ids = (ids * 2654435761) % data["id_space"]
    mask = np.arange(L)[None, None, :] < lengths[..., None]
    return np.where(mask, ids, 0).astype(np.int32), lengths


def raw_partition(data: Dict, rows: int, seed: int, fid: int, dup_factor: int = 1) -> Dict:
    """Raw features of file `fid` of dataset `seed`: ``dense`` (rows, n_dense)
    f32, ``sparse_values`` (rows, S, L) int32, ``sparse_lengths`` (rows, S)
    int32, ``labels`` (rows,) f32, and, for dedup traffic, ``sparse_refs``
    (rows,) int64, the session block of each row."""
    rng = np.random.default_rng((seed << 20) ^ fid)
    dense = rng.lognormal(mean=1.0, sigma=2.0, size=(rows, data["n_dense"])).astype(np.float32)
    if dup_factor <= 1:
        ids, lengths = _sparse_blocks(rng, data, rows)
        labels = (rng.random(size=(rows,)) < 0.25).astype(np.float32)
        return {"dense": dense, "sparse_values": ids, "sparse_lengths": lengths,
                "labels": labels}
    if rows % dup_factor or (rows // dup_factor) % 32:
        raise ValueError(f"rows={rows} needs rows/dup_factor divisible by 32")
    uids, ulens = _sparse_blocks(rng, data, rows // dup_factor)
    labels = (rng.random(size=(rows,)) < 0.25).astype(np.float32)
    refs = np.arange(rows, dtype=np.int64) // dup_factor
    return {"dense": dense, "sparse_values": uids[refs], "sparse_lengths": ulens[refs],
            "labels": labels, "sparse_refs": refs}
