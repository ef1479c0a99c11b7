"""Host milliseconds a sweep inside ``population.step_loop`` (the PyTorch
step loop of a layer that no scan kernel takes: an ATA-T core's recurrence
and phase B, enqueued a step at a time) in the span window."""

from perfbench import spans


def read(ctx):
    sw = spans.of(ctx)
    if sw is None:
        return None
    d = [s.end_ns - s.start_ns for s in sw.in_window({"population.step_loop"})]
    return 1e-6 * sum(d) / sw.trace.window.calls if d else None
