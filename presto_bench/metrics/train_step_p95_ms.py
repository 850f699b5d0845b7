"""train_step_p95_ms: the nearest-rank 95th percentile of the host-clock
intervals between consecutive completed steps of the window (each step ends
in a device sync; an interval holds the step and any wait for its batch)."""

from presto_bench.harness.common import percentile


def read(ctx):
    if ctx["kind"] != "train" or not ctx["intervals_s"]:
        return None
    return percentile(ctx["intervals_s"], 95) * 1e3
