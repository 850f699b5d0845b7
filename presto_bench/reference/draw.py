"""The DLRM's weights, drawn from the run's seed on the device.

Every leaf is drawn whole, in one call, by a ``torch.Generator`` of its
own on the device, seeded by the run's seed and the leaf's index, so any
leaf can be drawn again alone and comes out bitwise the same on the same
device: the benchmark draws the weights it hands to the program, and the
reference draws them again for itself.  A weight is uniform with the
standard deviation the program's schema gives it: 0.01 for a table,
1/sqrt(fan-in) for an MLP weight; biases are 0.  Each embedding table is
its own leaf of shape (rows, dim).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

_M63 = (1 << 63) - 1
TABLE_STD = 0.01


def leaf_seed(seed: int, index: int) -> int:
    """A generator seed for leaf `index` of run `seed` (any size of seed)."""
    h = (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    h ^= h >> 31
    return h & _M63


def mlp_dims(model: Dict, n_dense: int, n_tables: int) -> Tuple[List[int], List[int]]:
    """The bottom and top MLPs' widths, inputs first."""
    n_int = n_tables + 1
    bottom = [n_dense] + list(model["bottom_mlp"])
    top = [n_int * (n_int - 1) // 2 + model["bottom_mlp"][-1]] + list(model["top_mlp"])
    return bottom, top


def leaf_specs(model: Dict, data: Dict) -> Iterator[Tuple[str, Tuple[int, ...], float, int]]:
    """(name, shape, std, index) of every leaf; std 0 means zeros."""
    n_tables = data["n_sparse"] + data["n_generated"]
    for t in range(n_tables):
        yield f"tables.{t}", (data["embedding_rows"], model["emb_dim"]), TABLE_STD, t
    bottom, top = mlp_dims(model, data["n_dense"], n_tables)
    for group, dims, base in (("bottom", bottom, 10_000), ("top", top, 20_000)):
        for i in range(len(dims) - 1):
            yield f"{group}.w{i}", (dims[i], dims[i + 1]), 1.0 / math.sqrt(dims[i]), base + i
            yield f"{group}_b.b{i}", (dims[i + 1],), 0.0, -1


def draw_leaf(shape, std: float, index: int, seed: int, device) -> torch.Tensor:
    """One leaf, f32 on `device`."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if std == 0.0:
        return t.zero_()
    bound = std * math.sqrt(3.0)
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, index))
    return t.uniform_(-bound, bound, generator=g)


def draw_all(model: Dict, data: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf by name (tables as ``tables.<t>``)."""
    return {name: draw_leaf(shape, std, idx, seed, device)
            for name, shape, std, idx in leaf_specs(model, data)}
