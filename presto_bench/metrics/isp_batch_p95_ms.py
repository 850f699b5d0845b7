"""isp_batch_p95_ms: the nearest-rank 95th percentile, over every batch of
the window, of the host-clock time from its ``launch`` call to the return of
its ``deliver``."""

from presto_bench.harness.common import percentile


def read(ctx):
    if ctx["kind"] != "isp" or not ctx["latency_s"]:
        return None
    return percentile(ctx["latency_s"], 95) * 1e3
