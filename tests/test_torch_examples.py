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
    # the system level runs too, on a small mesh of CPU ranks
    out = presto_vs_disagg.main(["--device", "cpu", "--reps", "1", "--mesh", "2,2"])
    assert out["fused_ms"] > 0 and out["unfused_ms"] > 0
    assert len(out["system"]) == 4


def test_presto_vs_disagg_system_level_bytes_on_the_cpu():
    """Per-rank bytes: presto none, hybrid and disagg their host families'
    pages and batch keys over the data axis (disagg regathers gen from the
    hopped dense pages)."""
    from repro_torch.core import opgraph
    from repro_torch.core.spec import TransformSpec
    from repro_torch.data.synth import SyntheticRecSysSource

    cfg = presto_vs_disagg.SYSTEM_CONFIG
    spec = TransformSpec.from_source(SyntheticRecSysSource(cfg, rows=cfg.rows_per_partition))
    page_b = opgraph.family_page_bytes(spec, cfg.rows_per_partition)
    out_b = opgraph.family_batch_bytes(spec, cfg.rows_per_partition)
    ranks = presto_vs_disagg.system_level(torch.device("cpu"), (2, 2))
    assert {r["transport"] for r in ranks} == {"gloo"}
    for r in ranks:
        assert r["presto"]["calls"] == 0 and sum(r["presto"]["bytes"].values()) == 0
        for placement in ("hybrid", "disagg"):
            fams = r[placement]["host_families"]
            skip_gen = "gen" in fams and "dense" in fams
            want = sum(((0 if f == "gen" and skip_gen else page_b[f]) + out_b[f]) // 2
                       for f in fams)
            assert r[placement]["bytes"] == {"collective-permute": want, "all-reduce": 0,
                                             "all-gather": 0, "all-to-all": 0}
        assert r["disagg"]["host_families"] == opgraph.FAMILIES


@pytest.mark.parametrize("example", [quickstart, train_recsys_e2e, presto_vs_disagg])
def test_examples_default_to_cuda_and_raise_without_it(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
