"""The port's lowering cells and per-rank dry run (``launch.specs``'s
``build_*_cell``, ``launch.dryrun``) against the JAX package's on 512 fake
devices (one ``conftest.run_sharded`` script, no compile but for two
reduced cells):

* every arch x shape x production mesh: the port's rank 0 block of every
  argument leaf has the shape of the reference's
  ``NamedSharding(...).shard_shape``, and the cells the reference skips are
  skipped with its reason;
* a sharded axis that does not divide raises ``ValueError`` on both sides
  (jax 0.9.0's ``shard_shape`` pads no uneven block, and neither does the
  port);
* two reduced cells: the port's summed argument bytes equal the compiled
  reference's ``memory_analysis().argument_size_in_bytes``;
* the CLI (``--reduced``) writes one JSON line a cell with the reference's
  keys, and ``--skip-done`` skips what is done.
"""

import json
import pickle

import pytest
import torch

from conftest import run_sharded
from repro.configs.registry import ARCH_IDS
from repro.models.config import SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import build_cell

BYTES_CELLS = (("h2o-danube-1.8b", "decode_32k", False), ("mamba2-1.3b", "train_4k", True))

_REF = """
import pickle, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import ARCH_IDS, get_arch
from repro.launch.mesh import make_mesh, make_production_mesh
from repro.launch.specs import build_cell
from repro.models.config import SHAPES
out = {"cells": {}, "bytes": {}}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCH_IDS:
        entry = get_arch(arch)
        for shape in SHAPES:
            if shape in entry.skip_shapes:
                out["cells"][(arch, shape, multi)] = "skip"
                continue
            spec = build_cell(entry.config, shape, mesh)
            args = jax.tree_util.tree_flatten_with_path(spec.args)[0]
            shs = jax.tree_util.tree_flatten(spec.in_shardings,
                                             is_leaf=lambda x: isinstance(x, NamedSharding))[0]
            assert len(args) == len(shs)
            leaves = {}
            for (path, a), sh in zip(args, shs):
                name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                try:
                    leaves[name] = tuple(sh.shard_shape(a.shape))
                except ValueError:
                    leaves[name] = "raises"
            out["cells"][(arch, shape, multi)] = leaves
    for arch, shape, m in %(bytes_cells)r:
        if m == multi:
            spec = build_cell(get_arch(arch).reduced, shape, mesh)
            with mesh:
                c = jax.jit(spec.fn, in_shardings=spec.in_shardings).lower(*spec.args).compile()
            out["bytes"][(arch, shape, m)] = c.memory_analysis().argument_size_in_bytes
try:
    NamedSharding(make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8]),
                  P(None, "model")).shard_shape((3, 10))
    out["uneven"] = None
except ValueError as e:
    out["uneven"] = str(e)
pickle.dump(out, open(%(path)r, "wb"))
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dryrun") / "ref.pkl")
    assert "REF_OK" in run_sharded(_REF % {"path": path, "bytes_cells": BYTES_CELLS},
                                   devices=512, timeout=600)
    with open(path, "rb") as f:
        return pickle.load(f)


def port_leaves(arch: str, shape: str, multi: bool) -> dict:
    spec = build_cell(get_arch(arch).config, shape, D.production_mesh(multi))
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
        elif isinstance(node, tuple) and not hasattr(node, "dtype"):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}" if path else str(i))
        else:
            out[path] = tuple(node.shape)

    walk(spec.args, "")
    return out


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank_block_of_every_argument_leaf_is_the_references_shard_shape(ref, arch, shape,
                                                                         multi):
    want = ref["cells"][(arch, shape, multi)]
    if want == "skip":
        assert shape in get_arch(arch).skip_shapes
        rec = D.run_cell(arch, shape, multi, "")
        assert rec["status"] == "skip" and rec["reason"].startswith("inapplicable")
        return
    assert "raises" not in want.values()  # no production leaf is uneven
    assert port_leaves(arch, shape, multi) == want


def test_an_uneven_axis_raises_on_both_sides(ref):
    """10 columns over a 4-rank axis: the reference's ``shard_shape`` and
    the port's ``block_shape`` both refuse (no padded or ragged block)."""
    assert "should evenly divide the shape" in ref["uneven"]
    mesh = Mesh({"data": 2, "model": 4}, 0, torch.device("meta"), "none")
    with pytest.raises(ValueError, match="does not divide into 4 blocks"):
        S.block_shape((3, 10), mesh, (None, "model"))


@pytest.mark.parametrize("arch,shape,multi", BYTES_CELLS)
def test_argument_bytes_equal_the_compiled_references(ref, arch, shape, multi):
    spec = build_cell(get_arch(arch).reduced, shape, D.production_mesh(multi))
    assert D.tree_bytes(spec.args) == ref["bytes"][(arch, shape, multi)]


def test_any_rank_of_a_meta_mesh_answers_without_a_world():
    """A cell of rank 257 of the multi-pod mesh (pod 1, data 0, model 1)
    holds the blocks rank 0 does, at its own index."""
    cfg = get_arch("h2o-danube-1.8b").config
    spec0 = build_cell(cfg, "train_4k", D.production_mesh(True, 0))
    spec1 = build_cell(cfg, "train_4k", D.production_mesh(True, 257))
    assert D.tree_bytes(spec0.args) == D.tree_bytes(spec1.args)
    mesh = D.production_mesh(True, 257)
    assert mesh.coords == {"pod": 1, "data": 0, "model": 1}
    wq = spec1.in_shardings[0]["params"]["layers"]["p0"]["attn"]["wq"].spec
    index = S.block_index((cfg.n_periods, cfg.d_model, cfg.n_heads * cfg.hd), mesh, wq)
    assert index[2] == slice(160, 320) and index[1] == slice(0, 160)


def test_cli_writes_a_json_line_a_cell_and_skips_what_is_done(tmp_path, capsys):
    """At reduced width the MoE archs' 4 or 8 experts do not divide the
    16-way model axis: those cells are errors with the reason, as the
    reference's ``jit`` refuses them, and the sweep exits 1.  So are the
    reduced mamba2's serving cells: its 8 SSM heads do not divide the
    axis, which the reference's decode refuses too, and the port's prefill
    holds its caches in those blocks (the reference's compiler may place
    an output unevenly; the port's ranks hold even blocks only)."""
    out = tmp_path / "d.jsonl"
    with pytest.raises(SystemExit, match="1"):
        D.main(["--reduced", "--arch", "all", "--shape", "all", "--mesh", "both",
                "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 2 * len(ARCH_IDS) * len(SHAPES)
    errors = [r for r in recs if r["status"] == "error"]
    moe = {a for a in ARCH_IDS if get_arch(a).reduced.n_experts}
    assert {(r["arch"], r["shape"]) for r in errors} == (
        {(r["arch"], r["shape"]) for r in recs if r["arch"] in moe and r["status"] != "skip"}
        | {("mamba2-1.3b", s) for s in SHAPES if s != "train_4k"})
    assert all("does not divide into 16 blocks over model" in r["reason"] for r in errors)
    for r in recs:
        if r["status"] != "ok":
            continue
        assert set(r) >= {"arch", "shape", "mesh", "status", "reason", "chips", "memory",
                          "roofline"}
        assert r["memory"]["temp_bytes"] is None and r["memory"]["argument_bytes"] > 0
        assert r["chips"] == (512 if r["mesh"] == "multi" else 256)
        assert "not compiled" in r["roofline"]["flops_source"]
    capsys.readouterr()
    with pytest.raises(SystemExit, match="1"):
        D.main(["--reduced", "--out", str(out), "--skip-done"])
    assert len(out.read_text().splitlines()) == len(recs) + len(errors)
    assert f"dryrun complete: 0 ok/skip, {len(errors)} errors" in capsys.readouterr().out

