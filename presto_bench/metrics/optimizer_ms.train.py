"""optimizer_ms.train: device milliseconds a traced step of the work launched
inside the program's ``adamw`` range (global norm, clip and update)."""


def read(ctx):
    tv = ctx.get("trace_ranges")
    if tv is None or not ctx.get("trace_units"):
        return None
    t = tv.time_under_s(lambda n: n == "adamw")
    return t / ctx["trace_units"] * 1e3 if t > 0 else None
