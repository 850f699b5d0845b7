"""Tests that need a CUDA card; each skips without one.  On the machine with
the card: ``python -m pytest presto_bench -m card``.

- a whole run of ``run.py`` reports the card's name and one device;
- the control (the reference DLRM with TF32 matrix products in the
  program's place) fails a train cell's limits, at full widths and batch
  with 20,000-row tables, a size a test run holds;
- the planted fault of half the batch left out fails them too."""

import json
import subprocess
import sys

import pytest
import torch

from presto_bench.harness import check, control, files, inputs

SEED = 2**31 + 4242


@pytest.mark.card
def test_a_run_names_the_card(card, tmp_path):
    proc = subprocess.run(
        [sys.executable, "presto_bench/run.py", "--workload", "rm1-train-fed", "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=files.ROOT, capture_output=True, text=True, timeout=900,
        env={**__import__("os").environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["device"]["kind"] == torch.cuda.get_device_name(card)
    assert result["correct"], result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["rm2-train-fed", "rm1-train-fed"])
def test_the_control_and_a_fault_fail_the_limits(card, cell):
    entry = next(c for c in files.manifest()["workloads"] if c["name"] == cell)
    cf = files.cell_files(entry)
    cf["cfg"]["data"]["embedding_rows"] = 20_000
    data = inputs.data_config(cf["cfg"], cf["traffic"])
    _, params = inputs.transform_spec(data, SEED)
    got = control.train_control(cf["cfg"], data, SEED, lambda f: inputs.raw_partition(data, SEED, f),
                                params, [0, 1, 2], card)
    for side in ("control", "half_batch"):
        assert not check.verdict(got[side], cf["limits"])["correct"], (side, got[side])
