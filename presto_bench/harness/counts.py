"""Operations and bytes from shapes, and the card's published peaks.

Everything here is worked out from a cell's configuration and traffic, never
from the program's traces, so a change to the program cannot move it.
"""

from __future__ import annotations

import math
from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # bytes/s of HBM3

# AdamW's floor: the parameter and both moments, each read once and written
# once (the gradient is left out: an update need not materialise a dense one)
ADAMW_BYTES_PER_PARAM = 3 * 2 * 4


def n_tables(data: Dict) -> int:
    return data["n_sparse"] + data["n_generated"]


def param_count(model: Dict, data: Dict) -> int:
    t = n_tables(data)
    n_int = t + 1
    bottom = [data["n_dense"]] + list(model["bottom_mlp"])
    top = [n_int * (n_int - 1) // 2 + model["bottom_mlp"][-1]] + list(model["top_mlp"])
    mlp = sum(a * b + b for dims in (bottom, top) for a, b in zip(dims, dims[1:]))
    return t * data["embedding_rows"] * model["emb_dim"] + mlp


def train_step_flops(model: Dict, data: Dict, rows: int) -> float:
    """Model FLOPs of one training step on `rows` samples, at 2 FLOPs a
    multiply-add: forward and backward of both MLPs (the backward twice the
    forward, but once for the first bottom layer, whose input needs no
    gradient), of the pairwise interaction (the (T+1, D) x (D, T+1) product;
    its backward two such products), and the pooling adds of the bags
    forward and backward at the configuration's average bag length.  No
    recompute."""
    t, d = n_tables(data), model["emb_dim"]
    n_int = t + 1
    bottom = [data["n_dense"]] + list(model["bottom_mlp"])
    top = [n_int * (n_int - 1) // 2 + model["bottom_mlp"][-1]] + list(model["top_mlp"])
    macs_b = [a * b for a, b in zip(bottom, bottom[1:])]
    macs_t = [a * b for a, b in zip(top, top[1:])]
    mlp = 3 * (sum(macs_b) + sum(macs_t)) - macs_b[0]
    inter = 3 * n_int * n_int * d
    per_sample = 2 * (mlp + inter)
    pooled_ids = data["n_sparse"] * data["avg_sparse_len"] + data["n_generated"]
    per_sample += 2 * pooled_ids * d
    return float(per_sample) * rows


def optimizer_floor_s(model: Dict, data: Dict) -> float:
    return ADAMW_BYTES_PER_PARAM * param_count(model, data) / PEAK_HBM_BYTES


def transform_kernel_costs(data: Dict, rows: int, dup_factor: int = 1) -> Dict[str, Dict]:
    """Bytes and operations of each fused Transform kernel for one partition
    of `rows` rows: every input byte read once and every output byte written
    once, at the shapes these inputs need (the sparse chain at the unique
    blocks' geometry under dedup).  Operations: one Log a dense value; 11
    integer operations a SigridHash; log2(m + 1) comparisons a Bucketize."""
    u = rows // dup_factor
    nd, ns, ng = data["n_dense"], data["n_sparse"], data["n_generated"]
    L, m = data["max_sparse_len"], data["bucket_size"]
    id_width = max(int(data["id_space"] - 1).bit_length(), 1)
    hash_ops = 11
    sparse_vals = ns * u * L
    gen_vals = ng * rows
    return {
        "fused_dense": {"bytes": nd * rows * 4 * 2, "ops": nd * rows},
        "fused_sparse": {
            "bytes": ns * (u * L // 32) * id_width * 4 + sparse_vals * 4 + ns * 2 * 4,
            "ops": sparse_vals * hash_ops,
        },
        "fused_gen": {
            "bytes": gen_vals * 4 + ng * m * 4 + ng * 2 * 4 + gen_vals * 4,
            "ops": gen_vals * (hash_ops + math.ceil(math.log2(m + 1))),
        },
    }


def floor_s(cost: Dict) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the f32 rate, whichever is larger."""
    return max(cost["bytes"] / PEAK_HBM_BYTES, cost["ops"] / PEAK_F32_FLOPS)
