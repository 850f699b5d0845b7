"""setup_s: seconds from the process's start to the window's start (inputs,
weights, the first build and every warm-up step included)."""


def read(ctx):
    return ctx["setup_s"]
