"""The port's server entry point, ``repro_torch.launch.serve_preprocess``.

Runs the README's drills in-process on the CPU (``--device cpu``, reduced
geometry): the shared cache, dedup with the block tier, the kill and restart
drill with its event stream, and the storage-fault drill, each with
``--verify`` where the README has it (every delivered batch bitwise a solo
recompute).  ``main`` returns the per-job stats it prints.  With no device
given the CLI runs on CUDA and raises when no card is present.
"""

import json

import pytest
import torch

from repro.launch import serve_preprocess as ref_serve
from repro_torch.launch import serve_preprocess

FAULTS = "transient=0.25,corrupt=0.15,spill=0.4,offline=1@8,seed=13"


def run(capsys, *argv):
    stats = serve_preprocess.main([*argv, "--device", "cpu"])
    return stats, capsys.readouterr().out


def test_shared_cache_drill(capsys):
    stats, out = run(capsys, "--jobs", "3", "--reduced", "--cache")
    assert sorted(stats) == ["rm1-job0", "rm1-job1", "rm1-job2"]
    assert all(st.done and not st.cancelled and st.delivered == 6 for st in stats.values())
    assert sum(st.cache_hits for st in stats.values()) > 0  # same content, 3 tenants
    assert "device=cpu" in out and "cache: hits=" in out


def test_dedup_drill_verifies_bitwise(capsys):
    stats, out = run(capsys, "--jobs", "2", "--reduced", "--cache", "--dup-factor", "4",
                     "--verify")
    assert "verify: 2 job(s) x 6 partitions bitwise identical" in out
    assert sum(st.blocks_published for st in stats.values()) > 0
    assert "dedup: moved" in out


def test_kill_and_restart_drill_verifies_bitwise(capsys, tmp_path):
    events = tmp_path / "EVENTS_chaos.json"
    stats, out = run(capsys, "--jobs", "2", "--reduced", "--kill", "1@3",
                     "--restart-after", "8", "--verify", "--events-out", str(events))
    assert "chaos: killed worker 1" in out or "chaos: worker 1 already gone" in out
    assert "chaos: restarting the service after 8" in out and "chaos: resuming" in out
    assert "bitwise identical to solo recompute" in out
    assert all(st.done for st in stats.values())
    kinds = {e["kind"] for e in json.loads(events.read_text())}
    assert {"worker_leave", "checkpoint", "session_join"} <= kinds


def test_storage_fault_drill_verifies_bitwise(capsys):
    stats, out = run(capsys, "--jobs", "2", "--reduced", "--cache", "--io-faults", FAULTS,
                     "--io-retries", "4", "--verify")
    assert all(st.quarantined == 0 and st.done for st in stats.values())
    assert sum(st.retries for st in stats.values()) > 0
    assert "device_offline=1" in out and "bitwise identical to solo recompute" in out


def test_megabatch_lookahead_kill_drill(capsys):
    """The chip smoke's service drill at reduced width, with a kill: two
    tenants of the same content on 4 devices, megabatch 2, lookahead 2 with
    pre-warm off (so the window pre-stages)."""
    stats, out = run(capsys, "--jobs", "2", "--reduced", "--partitions", "6", "--devices",
                     "4", "--cache", "--megabatch", "2", "--lookahead", "2", "--no-prewarm",
                     "--kill", "1@3", "--verify")
    assert "verify: 2 job(s) x 6 partitions bitwise identical" in out
    assert sum(st.cache_hits for st in stats.values()) > 0
    assert any(st.staged_bytes_peak > 0 for st in stats.values())


DRILL = "--rm rm2 --reduced --rows 256 --jobs 2 --devices 4 --cache --megabatch 2 --lookahead 2"


def ref_table(capsys, argv) -> list:
    """The reference CLI's per-job table (its ``main`` returns nothing), one
    dict per job keyed by the header's column names."""
    ref_serve.main(argv)
    lines = capsys.readouterr().out.splitlines()
    head = next(i for i, line in enumerate(lines) if line.split()[:2] == ["job", "batches"])
    names = lines[head].split()
    return [dict(zip(names, line.split())) for line in lines[head + 1:] if line.strip()
            and line.split()[0].startswith("rm")]


@pytest.mark.parametrize("flags, staged_jobs, block_hits", [
    # the issue's 4-partition service drill, pre-warm on: the window pids
    # are leased by the other tenant's claims, so neither tenant pre-stages
    (DRILL + " --partitions 4 --kill 1@3 --verify", 0, None),
    # the chip smoke's service drill: 6 partitions, pre-warm off
    (DRILL + " --partitions 6 --no-prewarm --verify", 2, None),
    # the chip smoke's dedup drill: 8 partitions, so pids are claimed after
    # blocks were published
    ("--rm rm2 --reduced --rows 256 --dup-factor 4 --dup-pool 16 --cache --jobs 2 "
     "--partitions 8 --verify", 0, True),
], ids=["issue-service-4p-prewarm", "smoke-service-6p", "smoke-dedup-8p"])
def test_drill_sizing_matches_reference(capsys, flags, staged_jobs, block_hits):
    """The chip smoke's drills are sized from how the reference's service
    behaves at these flags: the jobs that pre-stage and whether any batch is
    assembled from blocks are the same in both packages."""
    argv = flags.split()
    ref = ref_table(capsys, argv)
    stats, _out = run(capsys, *argv)
    assert len(ref) == len(stats) == 2
    assert sum(row["staged"] != "-" for row in ref) == staged_jobs
    assert sum(st.staged_bytes_peak > 0 for st in stats.values()) == staged_jobs
    if block_hits:
        assert sum(int(row["blk"].split("/")[0]) for row in ref) > 0
        assert sum(st.block_hits for st in stats.values()) > 0


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_preprocess.main(["--jobs", "1", "--reduced", "--partitions", "1"])
