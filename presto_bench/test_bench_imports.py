"""What a run loads and where it refuses to run.

A run may load no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: the program is ``repro_torch``), and
the reference may load nothing of the program either.  ``run.py`` fails,
and prints no result, without a card and without the program beside it."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from presto_bench.harness.common import FORBIDDEN_MODULES
from presto_bench.harness.files import BENCH, ROOT

RUN_SMALL = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
import torch
from presto_bench.conftest import small_files
from presto_bench.harness.cells import run_cell
for cell in ("rm2-isp", "rm1-train-fed"):
    run_cell(cell, 7, 0.3, False, torch.device("cpu"), time.perf_counter(), files=small_files(cell))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

IMPORT_REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import presto_bench.reference.dlrm, presto_bench.reference.draw, presto_bench.reference.transform
import presto_bench.traffic.generator
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = str(tmp_path)
    return env


def _tops(script, tmp_path):
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=_env(tmp_path), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(__import__("json").loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_reference_package(tmp_path):
    tops = _tops(RUN_SMALL.format(src=str(ROOT / "src"), root=str(ROOT)), tmp_path)
    assert "repro_torch" in tops and "presto_bench" in tops
    assert not tops & set(FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    tops = _tops(IMPORT_REFERENCE.format(root=str(ROOT)), tmp_path)
    assert not tops & (set(FORBIDDEN_MODULES) | {"repro_torch"})


@pytest.mark.parametrize("sub", ["harness", "reference", "traffic", "metrics"])
def test_no_source_names_a_forbidden_module(sub):
    """No source names ``jax`` or the reference package; the reference and
    the traffic's generator, which the reference reads, name nothing of the
    program either (the traffic's drivers run the program)."""
    for path in sorted((BENCH / sub).glob("*.py")):
        banned = set(FORBIDDEN_MODULES)
        if sub == "reference" or path.name in ("generator.py", "__init__.py"):
            banned.add("repro_torch")
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not {n.split(".")[0] for n in names} & banned, (path, names)


def _run_py(cwd, tmp_path):
    return subprocess.run(
        [sys.executable, "presto_bench/run.py", "--workload", "rm1-train-fed", "--seed",
         str(2**32 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=_env(tmp_path), timeout=600)


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run_py(ROOT, tmp_path)
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


def test_no_program_no_result(tmp_path):
    alone = tmp_path / "alone"
    shutil.copytree(BENCH, alone / "presto_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone / "BENCHMARK.json")
    proc = _run_py(alone, tmp_path)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
