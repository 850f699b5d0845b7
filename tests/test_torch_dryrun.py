"""The port's lowering cells and per-rank dry run (``launch.specs``'s
``build_*_cell``, ``launch.dryrun``) against the JAX package's on 512 fake
devices (one ``conftest.run_sharded`` script, no compile but for five
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
* three reduced cells on a (data=2, model=2) mesh (the reduced configs'
  4 to 8 heads, experts and SSM heads do not split over the production
  mesh's 16-way model axis in the port): the trace's FLOPs a rank within
  2% of ``hlo_cost.analyze`` of the compiled reference, less the one
  difference of layout (``replicated_bcdt_flops``);
* the CLI writes one JSON line a cell with the reference's keys, the
  memory and roofline columns numeric (``--reduced`` on a (2, 2) mesh, and
  one production cell), and ``--skip-done`` skips what is done.
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
from repro_torch.launch import trace_cost
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models.ssm import ssm_dims

BYTES_CELLS = (("h2o-danube-1.8b", "decode_32k", False), ("mamba2-1.3b", "train_4k", True))
COST_CELLS = (("h2o-danube-1.8b", "decode_32k"), ("mamba2-1.3b", "train_4k"),
              ("jamba-v0.1-52b", "prefill_32k"))

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
from repro.launch import hlo_cost
mesh4 = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
out["cost"] = {}
for arch, shape in %(cost_cells)r:
    spec = build_cell(get_arch(arch).reduced, shape, mesh4)
    with mesh4:
        c = jax.jit(spec.fn, in_shardings=spec.in_shardings).lower(*spec.args).compile()
    cost = hlo_cost.analyze(c.as_text())
    out["cost"][(arch, shape)] = (cost.flops, dict(cost.coll_breakdown))
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
    assert "REF_OK" in run_sharded(_REF % {"path": path, "bytes_cells": BYTES_CELLS,
                                           "cost_cells": COST_CELLS},
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


REF_ROOFLINE_KEYS = {"flops_per_dev", "hbm_bytes_per_dev", "coll_bytes_per_dev",
                     "coll_breakdown", "model_flops_global", "chips", "compute_s", "memory_s",
                     "collective_s", "dominant", "useful_ratio", "roofline_fraction"}


def test_cli_writes_a_json_line_a_cell_and_skips_what_is_done(tmp_path, capsys):
    """``--reduced`` traces the smoke-size configs on a (2, 2) mesh (2 x 2 x 2
    multi-pod): their 4 to 8 heads, experts and SSM heads divide it, where
    the production mesh's 16-way model axis does not.  Every cell but the
    reference's skips is ok, with the reference's keys and the memory and
    roofline columns numeric, and ``--skip-done`` skips what is done."""
    out = tmp_path / "d.jsonl"
    D.main(["--reduced", "--arch", "all", "--shape", "all", "--mesh", "both",
            "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 2 * len(ARCH_IDS) * len(SHAPES)
    assert all(r["status"] == "ok" or (r["status"] == "skip"
                                       and r["shape"] in get_arch(r["arch"]).skip_shapes)
               for r in recs)
    assert {r["arch"] for r in recs if r["status"] == "ok"} == set(ARCH_IDS)
    for r in recs:
        if r["status"] != "ok":
            continue
        assert set(r) >= {"arch", "shape", "mesh", "status", "reason", "chips", "memory",
                          "roofline"}
        assert r["chips"] == (8 if r["mesh"] == "multi" else 4)
        mem = r["memory"]
        assert all(isinstance(v, int) for v in mem.values()) and mem["argument_bytes"] > 0
        assert mem["peak_estimate_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                              + mem["temp_bytes"] - mem["alias_bytes"])
        assert set(r["roofline"]) == REF_ROOFLINE_KEYS and r["roofline"]["flops_per_dev"] > 0
    capsys.readouterr()
    D.main(["--reduced", "--out", str(out), "--skip-done"])
    assert len(out.read_text().splitlines()) == len(recs)
    assert "dryrun complete: 0 ok/skip, 0 errors" in capsys.readouterr().out


def test_cli_records_the_cost_and_memory_columns(tmp_path, capsys):
    """A production cell at full width (h2o-danube-1.8b decode_32k, single
    pod): the reference's memory keys, all numbers, with its
    ``peak = args + out + temp - alias``; the roofline as
    ``RooflineTerms.to_json``; the rank and the concrete cache length the
    trace ran at; the printed line as the reference prints it."""
    out = tmp_path / "d.jsonl"
    D.main(["--arch", "h2o-danube-1.8b", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(out)])
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["rank"] == 0
    assert rec["cache_len"] == SHAPES["decode_32k"].seq_len - 1 and rec["build_s"] > 0
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "alias_bytes", "temp_bytes",
                        "peak_estimate_bytes"}
    assert all(isinstance(v, int) and v >= 0 for v in mem.values())
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                          + mem["temp_bytes"] - mem["alias_bytes"])
    assert mem["alias_bytes"] > 0 and mem["peak_estimate_bytes"] > mem["argument_bytes"]
    roof = rec["roofline"]
    assert set(roof) == REF_ROOFLINE_KEYS
    assert roof["flops_per_dev"] > 0 and roof["hbm_bytes_per_dev"] > 0
    assert roof["coll_bytes_per_dev"] == sum(roof["coll_breakdown"].values()) > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    line = capsys.readouterr().out
    assert "[ok] h2o-danube-1.8b x decode_32k x single:" in line
    assert "dominant=" in line and "terms(c/m/x)=(" in line and "rf=" in line


def replicated_bcdt_flops(cfg, shape, mesh) -> float:
    """The FLOPs a rank spends on its mamba layers' B/C/dt projection
    beyond a 1/k share of it, k the ranks of ``ff`` (``model``): the port
    keeps that weight replicated and computes the product whole on every
    rank (each rank's heads read every B and C), where XLA's partitioner
    splits its columns k ways and gathers them.  Forward, and in a train
    step the two backward products too ("dots" remat keeps the forward's)."""
    n_ssm = cfg.n_periods * sum(1 for p in cfg.period() if p.kind != "attn")
    if not n_ssm:
        return 0.0
    _, h, _, n = ssm_dims(cfg)
    k = mesh.shape["model"]
    rows = shape.global_batch // mesh.shape["data"]
    tokens = rows * (1 if shape.kind == "decode" else shape.seq_len)
    passes = 3 if shape.kind == "train" else 1
    return passes * (1 - 1 / k) * 2 * tokens * cfg.d_model * (2 * n + h) * n_ssm


@pytest.mark.parametrize("arch,shape", COST_CELLS)
def test_traced_flops_are_within_2_percent_of_hlo_cost(ref, arch, shape):
    """The reduced cell on (data=2, model=2): the port's traced FLOPs a rank
    against ``hlo_cost.analyze`` of the compiled reference, within 2% once
    the one FLOPs difference of layout is taken off the port's count:
    ``replicated_bcdt_flops``, 3.56% of mamba2's train step, 0.17% of
    jamba's prefill, none of h2o's decode.  Collective bytes by kind are
    printed beside the reference's; they differ where the layouts do:

    * ``all-gather``: the port counts what a rank sends (its block, the
      operand), ``hlo_cost`` max(operand, result), the gathered whole: the
      axis size (2) times the port's bytes for the same gathers (FSDP
      weights over ``data``, the vocab-split logits over ``model``); the
      reference also gathers the B/C/dt projection's column blocks, which
      the port computes whole;
    * ``all-to-all`` and ``collective-permute`` (mamba2's train step,
      jamba's prefill): XLA's partitioner moves the SSD's chunked tensors
      and the MoE's dispatch buffers between shardings with them; the
      port's ranks keep their heads and experts and send none;
    * ``all-reduce``: the port sums each row-parallel product once (the
      Megatron "g") and its gradients once; XLA's partitioner places some
      sums elsewhere or merges them."""
    mesh = Mesh({"data": 2, "model": 2}, 0, torch.device("meta"), "none")
    cfg = get_arch(arch).reduced
    spec = build_cell(cfg, shape, mesh)
    cost = trace_cost.analyze(spec.fn, D.meta_args(spec, SHAPES[shape]), counter=mesh.counter)
    want, ref_coll = ref["cost"][(arch, shape)]
    layout = replicated_bcdt_flops(cfg, SHAPES[shape], mesh)
    print(f"{arch} x {shape}: flops {cost.flops} against {want} "
          f"({cost.flops / want - 1:+.4%}; less the replicated B/C/dt projection's {layout:.0f}, "
          f"{(cost.flops - layout) / want - 1:+.4%}); collective bytes by kind "
          f"{ {k: int(v) for k, v in cost.coll_breakdown.items()} } against "
          f"{ {k: int(v) for k, v in ref_coll.items()} }")
    assert abs((cost.flops - layout) / want - 1) <= 0.02
