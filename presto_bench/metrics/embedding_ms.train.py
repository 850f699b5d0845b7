"""embedding_ms.train: device milliseconds a traced step of the work launched
inside the program's ``dlrm.embedding_bag`` range and inside the autograd
node of its backward."""


def _match(name):
    return name == "dlrm.embedding_bag" or name.startswith(
        "autograd::engine::evaluate_function: EmbeddingBagBackward")


def read(ctx):
    tv = ctx.get("trace_ranges")
    if tv is None or not ctx.get("trace_units"):
        return None
    t = tv.time_under_s(_match)
    return t / ctx["trace_units"] * 1e3 if t > 0 else None
