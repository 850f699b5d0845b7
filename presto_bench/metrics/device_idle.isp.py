"""The share of the device-only traced stretch in which no kernel, copy or
memset ran on the device, in percent: one minus the union of the traced
device operations' times over the stretch's length, both of the one
stretch (its length is the host clock between the device syncs at its
ends).  The profiler's own host time, some tens of microseconds a launch,
lies in that stretch, so where the host sets the pace this reads above the
untraced window's idle share."""


def read(ctx):
    tv = ctx.get("trace")
    if tv is None or not ctx.get("trace_window_s"):
        return None
    return (1.0 - tv.busy_s() / ctx["trace_window_s"]) * 100
