"""The benchmark's operation and byte counts against values worked out by
hand from the configurations (and, where it gives them, from the repository's
kernel table and training measurements)."""

import json

import pytest

from presto_bench.harness import counts
from presto_bench.harness.files import BENCH


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_param_counts():
    # 63 x 500,000 x 128 tables, 504-512-256-128 and 2144-1024-1024-512-256-1 MLPs
    rm2 = _cfg("rm2")
    assert counts.param_count(rm2["model"], rm2["data"]) == 4_036_325_249
    rm1 = _cfg("rm1")
    tables = 39 * 500_000 * 128
    bottom = 13 * 512 + 512 + 512 * 256 + 256 + 256 * 128 + 128
    top = 908 * 1024 + 1024 + 1024 * 1024 + 1024 + 1024 * 512 + 512 + 512 * 256 + 256 + 256 + 1
    assert counts.param_count(rm1["model"], rm1["data"]) == tables + bottom + top


@pytest.mark.parametrize("name, flops", [
    # per sample: 2 x (3 x MLP MACs less the first bottom layer's input
    # gradient + 3 x (T+1)^2 x D) + 2 x pooled ids x D
    ("rm2", 8192 * (2 * (3 * (421_888 + 3_899_648) - 258_048 + 3 * 64 * 64 * 128)
                    + 2 * (42 * 20 + 21) * 128)),
    ("rm1", 8192 * (2 * (3 * (170_496 + 2_633_984) - 6_656 + 3 * 40 * 40 * 128)
                    + 2 * (26 + 13) * 128)),
])
def test_train_step_flops(name, flops):
    cfg = _cfg(name)
    assert counts.train_step_flops(cfg["model"], cfg["data"], 8192) == flops
    assert flops == {"rm2": 235_759_730_688, "rm1": 147_884_867_584}[name]


def test_optimizer_floor():
    rm2 = _cfg("rm2")
    assert counts.optimizer_floor_s(rm2["model"], rm2["data"]) == pytest.approx(
        24 * 4_036_325_249 / 3.35e12)


@pytest.mark.parametrize("dup, expect", [
    # the kernel table's bytes at rm2's shapes (inputs read once, outputs
    # written once); dedup 4 runs the sparse chain at 2,048 blocks
    (1, {"fused_dense": 33_030_144, "fused_sparse": 77_070_672, "fused_gen": 1_462_440}),
    (4, {"fused_dense": 33_030_144, "fused_sparse": 42 * 2048 * 24 * 4 + 42 * 2048 * 32 * 4 + 336,
         "fused_gen": 1_462_440}),
])
def test_transform_kernel_bytes(dup, expect):
    rm2 = _cfg("rm2")
    got = counts.transform_kernel_costs(rm2["data"], 8192, dup)
    assert {k: v["bytes"] for k, v in got.items()} == expect
    for cost in got.values():  # every kernel is bound by its bytes
        assert counts.floor_s(cost) == cost["bytes"] / counts.PEAK_HBM_BYTES
