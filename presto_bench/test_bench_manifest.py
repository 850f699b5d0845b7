"""``BENCHMARK.json`` against the benchmark's contract: names, units and
text fields of the allowed characters and lengths; every file, reader and
limit that a name points at exists; every per-layer metric's cells report
the end-to-end metric it moves; every cell reports ``setup_s``, another
end-to-end metric and a per-layer one."""

import re

import pytest

from presto_bench.harness import files

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion", "emb",
               "mlp", "experts_per_token")

BENCH = files.manifest()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = {c["name"]: c for c in BENCH["workloads"]}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (files.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_text(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_text():
    names = [m["name"] for m in METRICS] + list(CELLS) + [c["name"] for c in BENCH["configs"]]
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    assert all(NAME.match(n) for n in names)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"]) and _text(c["why"])
        assert c["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _text(c["why"]) and _text(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not [k for k in c["reduced"] if k.endswith(("_dim", "_rank"))
                    or any(w in k for w in WIDTH_WORDS)]
    for m in BENCH["per_layer"]:
        assert _text(m["layer"])


def test_keys_of_each_entry():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for c in BENCH["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] <= 0.25


def test_files_behind_the_names():
    cfg_files = [c["file"] for c in BENCH["configs"]]
    assert len(set(cfg_files)) == len(cfg_files)
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert c["file"] == f"presto_bench/configs/{c['name']}.json"
        assert (files.ROOT / c["file"]).is_file()
    for m in METRICS:
        assert (files.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for c in CELLS.values():
        f = files.cell_files(c)  # the configuration, traffic and limits files
        assert (files.BENCH / "traffic" / f"{f['traffic']['driver']}.py").is_file()
        assert f["traffic"]["store"] in ("files", "memory")
        assert set(f["limits"]) >= {"batch_ids", "batch_dense"}
    used = {c["config"] for c in CELLS.values()}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(c["config"], c["traffic"]) for c in CELLS.values()]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in files.metrics_for(BENCH, cell, False)}
    layer = files.metrics_for(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:  # each per-layer metric's cells report the metric it moves
        assert m["moves"] in e2e


def test_layers_are_named_alike():
    by_metric_stem = {}
    for m in BENCH["per_layer"]:
        by_metric_stem.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_metric_stem.values())
    perf = (files.ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"| {layer} |" in perf, f"PERF.md's list of layers lacks {layer!r}"
