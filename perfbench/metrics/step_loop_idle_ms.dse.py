"""Device-idle milliseconds a sweep in the span window while the host was
inside ``population.step_loop``: the card waiting on the host's enqueue of
the step loop's recurrence products and phase-B ops."""

from perfbench import spans


def read(ctx):
    sw = spans.of(ctx)
    if sw is None or not sw.in_window({"population.step_loop"}):
        return None
    return 1e-6 * sw.idle_inside({"population.step_loop"}) / sw.trace.window.calls
