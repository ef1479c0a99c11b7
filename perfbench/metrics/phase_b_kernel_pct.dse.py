"""Share of the sweep's layer windows whose phase B ran as one kernel call,
in the span window: 100 x the ``lif_scan`` and ``ataf_scan`` kernel spans
inside ``population.sweep`` spans, over those sweeps times the net's layers
(a sweep is one data batch).  A layer left on the PyTorch step loop opens
no such span."""

from perfbench import spans

SCANS = ("lif_scan", "ataf_scan")


def read(ctx):
    sw = spans.of(ctx)
    if sw is None:
        return None
    sweeps = sw.in_window({"population.sweep"})
    if not sweeps:
        return None
    inside = sum(
        any(w.start_ns <= s.start_ns and s.end_ns <= w.end_ns for w in sweeps)
        for s in sw.in_window(SCANS)
    )
    return 100.0 * inside / (len(sweeps) * len(ctx.driver.layers))
