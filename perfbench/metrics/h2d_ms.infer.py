"""Device milliseconds of host-to-device copies per 1,000 samples classified
in the traced window."""


def read(ctx):
    seconds, n = ctx.trace.time_of("Memcpy HtoD")
    if not n:
        return None
    return 1e3 * seconds / (ctx.trace.window.units / 1e3)
