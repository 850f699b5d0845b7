"""launch_host_us.isp: host microseconds of ``TorchPreStoEngine.launch`` a
batch: the benchmark's clock around each call of the window (copy-in and
Transform enqueued, nothing waited for), summed and divided by the window's
batches (a launch of ``megabatch`` partitions makes that many)."""


def read(ctx):
    if ctx["kind"] != "isp" or not ctx["launch_s"] or not ctx["units"]:
        return None
    return sum(ctx["launch_s"]) / ctx["units"] * 1e6
