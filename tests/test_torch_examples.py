"""The port's examples run on the CPU with ``--device cpu``: the quickstart
(five partitions through a service session into the DLRM, every loss
finite) and a 6-step ``train_recsys_e2e`` (the ~100M DLRM, provisioning,
a checkpoint, a falling loss).  Without ``--device`` each asks for CUDA
and raises with no card."""

import numpy as np
import pytest
import torch

from repro_torch.examples import presto_vs_disagg, quickstart, train_recsys_e2e


def test_quickstart_on_the_cpu():
    losses = quickstart.main(["--device", "cpu"])
    assert len(losses) == 5 and all(np.isfinite(losses))


def test_train_recsys_e2e_six_steps_on_the_cpu():
    out = train_recsys_e2e.main(["--steps", "6", "--device", "cpu"])
    assert out["steps"] == 6 and out["checkpoint_step"] == 6
    assert 99e6 < out["params"] < 110e6  # ~100M: 39 x 20,000 x 128 tables + MLPs
    assert out["losses"][-1] < out["losses"][0]


def test_presto_vs_disagg_kernel_level_on_the_cpu():
    out = presto_vs_disagg.main(["--device", "cpu", "--reps", "1"])
    assert out["fused_ms"] > 0 and out["unfused_ms"] > 0


@pytest.mark.parametrize("example", [quickstart, train_recsys_e2e, presto_vs_disagg])
def test_examples_default_to_cuda_and_raise_without_it(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
