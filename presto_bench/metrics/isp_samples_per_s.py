"""isp_samples_per_s: rows delivered in the window over the window's seconds
(host clock; the window ends at the last delivery's sync)."""


def read(ctx):
    if ctx["kind"] != "isp" or not ctx["window_s"]:
        return None
    return ctx["rows"] / ctx["window_s"]
