"""The frozen reference and inputs against the program's plain CPU path, at
small shapes with the configurations' widths: the generator against the
program's synthetic source, the reference Transform against the program's
lowered Transform, and the reference DLRM and AdamW against the program's
model and train step on the same drawn weights."""

import numpy as np
import pytest
import torch

from presto_bench.conftest import small_files
from presto_bench.harness import cells, check, inputs
from presto_bench.reference import dlrm, draw
from presto_bench.reference import transform as ref_transform

SEED = 2**31 + 977


def _data(cell):
    f = small_files(cell)
    return f, inputs.data_config(f["cfg"], f["traffic"])


@pytest.mark.parametrize("cell", ["rm2-isp", "rm1-train-fed"])
def test_generator_is_the_programs_source(cell):
    from repro_torch.data.synth import SyntheticRecSysSource

    _, data = _data(cell)
    spec, params = inputs.transform_spec(data, SEED)
    src = SyntheticRecSysSource(spec.cfg, seed=SEED)
    raw = inputs.raw_partition(data, SEED, 3)
    want = src.raw(3)
    np.testing.assert_array_equal(raw["dense"], want.dense)
    np.testing.assert_array_equal(raw["sparse_values"], want.sparse_values)
    np.testing.assert_array_equal(raw["sparse_lengths"], want.sparse_lengths)
    np.testing.assert_array_equal(raw["labels"], want.labels)
    np.testing.assert_array_equal(params["bucket_boundaries"], src.bucket_boundaries)


@pytest.mark.parametrize("cell", ["rm2-isp", "rm2-isp-dedup4", "rm1-train-fed"])
def test_reference_transform_equals_the_program(cell):
    from repro_torch.core.presto import TorchPreStoEngine

    _, data = _data(cell)
    spec, params = inputs.transform_spec(data, SEED)
    parts = [inputs.make_file(data, SEED, f, None) for f in range(2)]
    store = inputs.memory_store(parts)
    engine = TorchPreStoEngine(spec, device="cpu")
    for f in range(2):
        (batch,), _ = engine.launch(engine.pin_pages(engine.stage_megabatch(store, [f])))
        numbers = check.batch_numbers([(f, batch)], lambda i: inputs.raw_partition(data, SEED, i),
                                      params)
        assert numbers["batch_ids"] == 0
        assert numbers["batch_dense"] < 1e-6


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.1415927, -2.5e-3], np.float32)
    got = ref_transform.to_bfloat16(x)
    want = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_reference_dlrm_and_adamw_follow_the_program():
    from repro_torch.launch.train import recsys_step
    from repro_torch.models import recsys as RS
    from repro_torch.train import init_state

    f, data = _data("rm2-train-fed")
    cfg = f["cfg"]
    spec, params = inputs.transform_spec(data, SEED)
    rcfg = inputs.recsys_config(cfg, spec)
    dev = torch.device("cpu")
    model = RS.DLRM(rcfg, cells.driver("train").program_params(cfg["model"], data, SEED, dev))
    opt, step = recsys_step(rcfg, cfg["train"]["lr"], cfg["train"]["schedule_steps"])
    state = init_state(model, opt)
    batches = check.reference_batches(lambda i: inputs.raw_partition(data, SEED, i), params,
                                      [0, 1], dev)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    ref = dlrm.replay(cfg["model"], data, cfg["train"], SEED, batches, dev)
    assert losses == pytest.approx(ref["loss"], rel=1e-6)
    change = {}
    for name, shape, std, idx in draw.leaf_specs(cfg["model"], data):
        w0 = draw.draw_leaf(shape, std, idx, SEED, dev)
        if name.startswith("tables."):
            p = model.tables.detach()[int(name.split(".")[1])]
        else:
            group, key = name.split(".")
            p = getattr(model, group)[key].detach()
        change[name] = check.norm(p - w0)
    assert check.worst_leaf(change, ref["change"]) < 1e-5
    assert set(ref["grad"]) == set(change)


def test_the_float64_witness_follows_the_reference():
    """``witness.float64_grad_norms`` (tables cut to the rows a batch looks
    up) gives the reference's first clipped gradient leaf by leaf, to float32
    rounding."""
    from presto_bench import witness

    f, data = _data("rm2-train-fed")
    cfg = f["cfg"]
    _, params = inputs.transform_spec(data, SEED)
    dev = torch.device("cpu")
    batches = check.reference_batches(lambda i: inputs.raw_partition(data, SEED, i), params,
                                      [0], dev)
    ref = dlrm.replay(cfg["model"], data, cfg["train"], SEED, batches, dev)
    f64 = witness.float64_grad_norms(cfg["model"], data, cfg["train"], SEED, batches[0], dev)
    assert set(f64) == set(ref["grad"])
    assert max(witness.gaps_to(ref["grad"], f64).values()) < 1e-5
