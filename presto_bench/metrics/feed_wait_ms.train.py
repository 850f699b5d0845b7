"""feed_wait_ms.train: milliseconds a window step waited for its batch, from
the session's counter of the consumer's time blocked on the stream
(``SessionStats.wait_time_s``, the interval ``PipelineStats.starved_time_s``
times), its change across the window over the window's steps."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    return ctx["feed_wait_s"] / ctx["units"] * 1e3
