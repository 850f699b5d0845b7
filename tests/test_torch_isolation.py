"""The port stands alone: it imports nothing of jax or of the JAX package,
defaults to CUDA and raises without it, and its kernel bindings refuse CPU
tensors instead of falling back to the plain versions."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import opgraph
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.synth import RMDataConfig, SyntheticRecSysSource
from repro_torch.kernels import _binding, bucketize, decode, fused, lognorm, ops, sigridhash

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _small_spec():
    cfg = RMDataConfig("t", 4, 3, 4, 8, 2, 32, 1 << 16, 1024, rows_per_partition=256)
    return TransformSpec.from_source(SyntheticRecSysSource(cfg, rows=256))


def test_every_module_imports_without_jax_or_repro():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    )
    assert "repro_torch.core.presto" in modules and "repro_torch.kernels.fused" in modules
    assert {"repro_torch.train.checkpoint", "repro_torch.train.elastic",
            "repro_torch.launch.train", "repro_torch.core.simclock",
            "repro_torch.examples.quickstart", "repro_torch.examples.train_recsys_e2e",
            "repro_torch.examples.presto_vs_disagg", "repro_torch.launch.mesh",
            "repro_torch.distributed.comm", "repro_torch.distributed.sharding",
            "repro_torch.train.compression", "repro_torch.models.config",
            "repro_torch.models.transformer", "repro_torch.launch.serve",
            "repro_torch.configs.h2o_danube_1_8b", "repro_torch.configs.mamba2_1_3b",
            "repro_torch.models.ssm", "repro_torch.models.moe", "repro_torch.models.encdec",
            "repro_torch.examples.serve_lm", "repro_torch.data.tokens",
            "repro_torch.launch.specs", "repro_torch.launch.trace_cost",
            "repro_torch.launch.dryrun"} \
        <= set(modules)
    script = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append(node.module or "")
    assert any(m.startswith("repro_torch") for m in imported)
    assert not [m for m in imported if _forbidden(m)]


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    """No CUDA device: non-zero exit and no result line, from the repository
    and from a directory that holds chip_smoke.py and nothing else."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _small_spec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchPreStoEngine(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opgraph.lower_transform(spec)
    assert TorchPreStoEngine(spec, device="cpu").device.type == "cpu"


def test_kernel_bindings_refuse_cpu_tensors():
    words = torch.zeros((2, 3, 4), dtype=torch.int32)
    params = ops.hash_params([1, 2], [10, 10], torch.device("cpu"))
    bounds = torch.zeros((2, 128), dtype=torch.float32)
    before = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_dense(words)
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_sparse(torch.zeros((2, 3, 7), dtype=torch.int32), params, width=7)
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_gen(words, bounds, params)
    assert fused.LAUNCHES == before


def test_ops_send_cpu_tensors_to_the_plain_versions():
    w = np.random.default_rng(0).integers(0, 2**32, (2, 3, 4), dtype=np.uint32)
    before = dict(fused.LAUNCHES)
    out = ops.fused_dense(w)
    assert out.device.type == "cpu" and out.shape == (2, 12)
    assert fused.LAUNCHES == before


def test_standalone_bindings_refuse_cpu_tensors():
    params = ops.hash_params([1, 2], [10, 10], torch.device("cpu"))
    before = dict(_binding.LAUNCHES)
    calls = (
        lambda: decode.bitunpack(torch.zeros((2, 3, 7), dtype=torch.int32), width=7),
        lambda: decode.bitunpack_lengths(torch.zeros((2, 3, 6), dtype=torch.int32), width=6),
        lambda: decode.bytesplit(torch.zeros((2, 3, 4), dtype=torch.int32)),
        lambda: sigridhash.sigridhash(torch.zeros((2, 5), dtype=torch.int32), params),
        lambda: bucketize.bucketize(torch.zeros((2, 5)), torch.zeros((2, 128))),
        lambda: lognorm.lognorm(torch.zeros((3, 5, 7))),
    )
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _binding.LAUNCHES == before


def test_one_launch_counter_for_every_kernel():
    assert fused.LAUNCHES is _binding.LAUNCHES
    assert set(_binding.LAUNCHES) == {"fused_dense", "fused_sparse", "fused_gen", "bitunpack",
                                      "bitunpack.lengths", "bytesplit", "sigridhash",
                                      "bucketize", "lognorm", "embedding_bag",
                                      "embedding_bag.backward"}


def test_standalone_ops_send_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(1)
    before = dict(_binding.LAUNCHES)
    w = rng.integers(0, 2**32, (2, 3, 6), dtype=np.uint32)
    assert ops.decode_bitpack(w, width=6).device.type == "cpu"
    assert torch.equal(ops.decode_lengths(w, width=6), ops.decode_bitpack(w, width=6))
    x = ops.decode_bytesplit(w[..., :4])
    assert x.device.type == "cpu" and x.shape == (2, 12)
    assert ops.sigridhash(x.view(torch.int32), [1, 2], [10, 10]).device.type == "cpu"
    assert ops.bucketize(x, np.zeros((2, 4), np.float32)).device.type == "cpu"
    assert ops.lognorm(x).device.type == "cpu"
    assert _binding.LAUNCHES == before


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit to csrc/*.cuh renames every library, so no stale build of a
    source that includes it is reused."""
    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path("a")
    (csrc / "common.cuh").write_text("// v2\n")
    assert _build.library_path("a") != first
    (csrc / "common.cuh").write_text("// v1\n")
    assert _build.library_path("a") == first
    (csrc / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build.library_path("a") != first


def test_lengths_decode_is_counted_apart_from_the_sparse_decode(monkeypatch):
    """The op graph's two bitpack decodes launch the same kernel through two
    entry points: the sparse decode counts as "bitunpack", the lengths decode
    as "bitunpack.lengths", whatever their widths."""
    from repro_torch import kernels
    from repro_torch.core.opgraph import Decode, _op_fn

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(decode, "check", lambda *a, **k: None)
    monkeypatch.setattr(decode, "launch", lambda *a: None)
    saved = dict(_binding.LAUNCHES)
    try:
        _binding.reset_launches()
        w = torch.zeros((2, 3, 6), dtype=torch.int32)
        for kind, n in (("bitpack", 2), ("lengths", 3)):
            node = Decode("d", "sparse", ("w",), "v", encoding=kind, width=6)
            assert kernels.OP_KERNELS[node.kind] is getattr(ops, f"decode_{kind}")
            for _ in range(n):
                _op_fn(node, None, w.device)(w)
        assert _binding.LAUNCHES["bitunpack"] == 2
        assert _binding.LAUNCHES["bitunpack.lengths"] == 3
        fused.reset_launches()
        assert not any(_binding.LAUNCHES.values())
    finally:
        _binding.LAUNCHES.update(saved)


def test_chip_smoke_names_a_timing_row_for_every_counter():
    """Every launch counter is a kernel row of chip_smoke.py (source, TPU
    kernel replaced), and every stage kind of a lowered plan maps to one;
    the counters no stage maps to are the model's, which a train step
    launches."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert set(chip_smoke.SOURCES) == set(_binding.LAUNCHES) == set(chip_smoke.REPLACES)
    stages, model = set(chip_smoke.STAGE_KERNELS.values()), set(chip_smoke.MODEL_KERNELS)
    assert stages | model == set(_binding.LAUNCHES) and not stages & model
