"""produce_ms.train: pool-worker milliseconds a produced partition in the
window, from the session's own counters (``SessionStats.produce_time_s``
over ``produced``, their changes across the window): reading, page
building, pinning, the copy-in and the Transform, with any wait for the
device."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx.get("produced"):
        return None
    return ctx["produce_s"] / ctx["produced"] * 1e3
