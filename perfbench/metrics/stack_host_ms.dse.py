"""Mean host milliseconds of ``population.stack`` (stacking each layer's
leaves and building the decay registers) in the span window: once a sweep."""

from perfbench import spans


def read(ctx):
    sw = spans.of(ctx)
    if sw is None:
        return None
    d = [s.end_ns - s.start_ns for s in sw.in_window({"population.stack"})]
    return 1e-6 * sum(d) / len(d) if d else None
