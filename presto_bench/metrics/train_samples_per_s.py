"""train_samples_per_s: rows trained in the window over the window's
seconds (host clock; the window starts and ends at a step's device sync)."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["window_s"]:
        return None
    return ctx["rows"] / ctx["window_s"]
