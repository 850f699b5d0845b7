"""The manifest and the files a cell is made of, read without torch (the
run starts making its inputs before torch is imported)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(cell: Dict) -> Dict:
    """The configuration, traffic and limits files of a manifest cell."""
    return {
        "cfg": load_json(BENCH / "configs" / f"{cell['config']}.json"),
        "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(BENCH / "workloads" / f"{cell['name']}.json")["limits"],
    }


def metrics_for(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The manifest's metrics that a run of `cell` reports: the end-to-end
    ones without a trace, the per-layer ones with it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
