"""transform_busy_us.isp: device microseconds a traced batch in which a
kernel or a memset ran (copies left out): the Transform's kernels and its
glue."""


def read(ctx):
    tv = ctx.get("trace")
    if tv is None or not ctx.get("trace_units"):
        return None
    t = tv.busy_s(cats=("kernel", "gpu_memset"))
    return t / ctx["trace_units"] * 1e6 if t > 0 else None
