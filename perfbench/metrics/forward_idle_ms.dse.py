"""Device-idle milliseconds a sweep in the span window while the host was
inside ``population.forward``: the card waiting on the host's enqueue of the
kernels and of the phase-B loop's ops."""

from perfbench import spans


def read(ctx):
    sw = spans.of(ctx)
    if sw is None or not sw.in_window({"population.forward"}):
        return None
    return 1e-6 * sw.idle_inside({"population.forward"}) / sw.trace.window.calls
