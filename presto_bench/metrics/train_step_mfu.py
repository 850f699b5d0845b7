"""train_step_mfu: the model FLOPs of a step (``counts.train_step_flops``)
over the window's seconds a step times the card's 67 TFLOP/s of float32,
the configuration's precision, in percent."""

from presto_bench.harness import counts


def read(ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    rows = ctx["rows"] / ctx["units"]
    flops = counts.train_step_flops(ctx["model"], ctx["data"], int(rows))
    return flops / (ctx["window_s"] / ctx["units"] * counts.PEAK_F32_FLOPS) * 100
