"""Distinct candidate configurations scored over the whole held-out set, over
the whole window, which closes at the end of the sweep in flight at
``--seconds``."""


def read(ctx):
    return ctx.window.units / ctx.window.wall_s
