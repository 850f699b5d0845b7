"""The plain Transform of the PreSto paper (Fig. 1, Alg. 1 and 2), in numpy.

From the raw features that the benchmark generated (``traffic/generator``)
to the train-ready mini-batch the program delivers:

- ``dense``: log(1 + max(x, 0)) of every dense feature, (rows, n_dense) f32;
- ``multi_hot_ids``: SigridHash of every raw id slot, padding included,
  (rows, S, L) int32;
- ``lengths``: the bags' lengths, (rows, S) int32;
- ``one_hot_ids``: SigridHash of the Bucketize count (boundaries <= x) of
  the dense feature that feeds each generated feature, (rows, G) int32;
- ``labels``: (rows,) f32.

SigridHash (Alg. 2) on uint32 words: h = (v ^ seed * 0x9E3779B1) *
0xCC9E2D51 + seed, then murmur3's finalizer, modulo the table's rows.
``precision="bfloat16"`` rounds the dense values to bfloat16 before the Log
and the Bucketize and rounds the Log's result: the benchmark's control, one
precision below the configuration's float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

U32 = np.uint32


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bfloat16 (ties to even), as f32."""
    bits = np.ascontiguousarray(x, np.float32).view(U32)
    bits = bits + U32(0x7FFF) + ((bits >> U32(16)) & U32(1))
    return (bits & U32(0xFFFF0000)).view(np.float32)


def sigridhash(values: np.ndarray, seed, rows) -> np.ndarray:
    """int ids -> int32 rows in [0, rows); `seed` and `rows` broadcast."""
    v = np.asarray(values).astype(np.int64).astype(U32)
    s = np.asarray(seed, U32)
    with np.errstate(over="ignore"):
        h = (v ^ (s * U32(0x9E3779B1))) * U32(0xCC9E2D51) + s
        h ^= h >> U32(16)
        h *= U32(0x85EBCA6B)
        h ^= h >> U32(13)
        h *= U32(0xC2B2AE35)
        h ^= h >> U32(16)
    return (h % np.asarray(rows, U32)).astype(np.int32)


def transform(raw: Dict[str, np.ndarray], params: Dict[str, np.ndarray],
              precision: str = "float32") -> Dict[str, np.ndarray]:
    """The mini-batch of one raw partition (see the module)."""
    dense = raw["dense"]
    if precision == "bfloat16":
        dense = to_bfloat16(dense)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    norm = np.log1p(np.maximum(dense, np.float32(0))).astype(np.float32)
    if precision == "bfloat16":
        norm = to_bfloat16(norm)
    gen_cols = dense[:, params["generated_source"]]  # (rows, G)
    bounds = params["bucket_boundaries"]
    counts = np.stack([np.searchsorted(bounds[g], gen_cols[:, g], side="right")
                       for g in range(bounds.shape[0])], axis=1)
    return {
        "dense": norm,
        "multi_hot_ids": sigridhash(raw["sparse_values"],
                                    params["sparse_seeds"][None, :, None],
                                    params["sparse_max"][None, :, None]),
        "lengths": raw["sparse_lengths"].astype(np.int32),
        "one_hot_ids": sigridhash(counts, params["gen_seeds"][None, :],
                                  params["gen_max"][None, :]),
        "labels": raw["labels"].astype(np.float32),
    }
