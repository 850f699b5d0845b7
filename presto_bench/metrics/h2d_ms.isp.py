"""h2d_ms.isp: device milliseconds a traced batch of host-to-device copies
(the pinned pages' copy-in)."""


def read(ctx):
    tv = ctx.get("trace")
    if tv is None or not ctx.get("trace_units"):
        return None
    t = tv.time_s(lambda n: "HtoD" in n, cats=("gpu_memcpy",))
    return t / ctx["trace_units"] * 1e3 if t > 0 else None
