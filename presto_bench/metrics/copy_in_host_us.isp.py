"""copy_in_host_us.isp: host microseconds a traced batch inside the
program's ``engine.copy_in`` spans (``TorchPreStoEngine.launch`` enqueuing
the pinned pages' copies, ``put_pages``), on the thread that launched them,
in the host-and-device traced stretch.  The profiler's CPU activity is on
there and costs host time at each recorded operation, so this reads above
the share of the untraced window's ``launch_host_us.isp`` that it stands
for."""


def read(ctx):
    tv = ctx.get("trace_ranges")
    if tv is None or not ctx.get("trace_units"):
        return None
    t = sum(end - start for ranges in tv.ranges.values()
            for start, end, name in ranges if name == "engine.copy_in")
    return t / ctx["trace_units"] if t > 0 else None
