"""glue_us.isp: device microseconds a traced batch of the Transform's glue:
the operations launched inside the program's glue spans (the ``gen_words``
gather, ``form_batch``'s transposes and casts, the dedup gather-expand, the
megabatch's flattening and the hash parameters' stacking), summed by
``TraceView.time_under_s``.  What else ``engine.transform`` launches is
the Transform's kernels: the three fused ones and the lengths' decode."""

GLUE_SPANS = ("opgraph.gen_words", "opgraph.form_batch", "preprocess.dedup_expand",
              "preprocess.flatten_megabatch", "ops.hash_params")


def read(ctx):
    tv = ctx.get("trace_ranges")
    if tv is None or not ctx.get("trace_units"):
        return None
    t = tv.time_under_s(lambda n: n in GLUE_SPANS)
    return t / ctx["trace_units"] * 1e6 if t > 0 else None
