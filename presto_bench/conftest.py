"""Shared fixtures of the benchmark's tests.

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which decides inside the test whether a card is present and skips
on a machine without one.  The small shapes here keep every width of the
configurations but few rows, small tables and short id spaces, so a cell
runs on the CPU in seconds."""

import sys
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parents[1]
for _p in (_ROOT / "src", _ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_files(cell: str, **traffic):
    """The cell's files at the tests' small shapes (``traffic`` overrides)."""
    from presto_bench.harness import files

    entry = next(c for c in files.manifest()["workloads"] if c["name"] == cell)
    f = files.cell_files(entry)
    f["cfg"]["data"].update(embedding_rows=1024, rows_per_partition=256, bucket_size=64,
                            id_space=1 << 16)
    if f["traffic"]["driver"] == "train":
        f["traffic"].update(partition_ids=48, warmup_steps=4, trace_steps=2)
    else:
        f["traffic"].update(warmup_batches=4, trace_batches=4)
    f["traffic"].update(traffic)
    return f


SMALL_LIMITS = {"batch_ids": 0, "batch_dense": 1e-5, "loss": 1e-5, "grad": 1e-5, "update": 1e-5}
