"""optimizer_roofline.train: AdamW's floor (the parameters and both moments,
each read once and written once, 24 bytes a parameter, at 3.35 TB/s) over
its device time a step, in percent."""

from presto_bench.harness import counts


def read(ctx):
    tv = ctx.get("trace_ranges")
    if tv is None or not ctx.get("trace_units"):
        return None
    t = tv.time_under_s(lambda n: n == "adamw") / ctx["trace_units"]
    if t <= 0:
        return None
    return counts.optimizer_floor_s(ctx["model"], ctx["data"]) / t * 100
