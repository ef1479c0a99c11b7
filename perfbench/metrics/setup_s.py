"""Seconds from process start to the first timed call: inputs and weights made,
the program set up, its kernels built or loaded, one warm-up call."""


def read(ctx):
    return ctx.setup_s
