"""Host milliseconds of ``eval.gather`` (the batch's numpy gather and
transpose) and ``eval.h2d`` (the raster's copy to the card) per 1,000
samples classified in the span window."""

from perfbench import spans


def read(ctx):
    sw = spans.of(ctx)
    if sw is None:
        return None
    d = [s.end_ns - s.start_ns for s in sw.in_window({"eval.gather", "eval.h2d"})]
    if not d:
        return None
    return 1e-6 * sum(d) / (sw.trace.window.units / 1e3)
