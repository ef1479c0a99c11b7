"""Samples classified bit-exactly through ``eval_int``, over the whole window, which
closes at the end of the pass in flight at ``--seconds``."""


def read(ctx):
    return ctx.window.units / ctx.window.wall_s
