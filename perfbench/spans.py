"""The program's own spans and counters beside the device's events.

A traced run's readers of program spans and counters share one span window,
measured by the first of them that asks (``of``): a second driver of the
cell, built from the first one's configuration, traffic and seed (the first
has dropped its device state by the time the readers run), warmed up, then
``trace.traced_window`` as it is, for ``SPAN_S``, with the program's
recorder (``repro_torch.kernels.work.Recorder``) listening.  The window's
sweeps are held to the reference by the driver's own check; where they fail
it, or where the program has no recorder, there is no window and the readers
return nothing.  The device idle by program span goes to standard error.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np

from perfbench import trace

SPAN_S = 5.0
OUTSIDE = "outside the program"


@dataclasses.dataclass
class SpanWindow:
    trace: trace.Trace  # the window as ``traced_window`` measures it
    t0: int  # start of the window's first call (``time.time_ns()``)
    t1: int  # end of its last call, or of its last device span if later
    gaps: list[tuple[int, int]]  # the device's idle intervals in [t0, t1]
    owners: list[int]  # per gap: index in ``spans`` of the innermost span holding its middle, or -1
    spans: list  # the program's spans (``repro_torch.kernels.work.Span``), warm-up's too
    counts: dict  # the program's counters over the whole span window, warm-up call included

    def in_window(self, names) -> list:
        """The window's spans named in ``names``."""
        return [s for s in self.spans if s.name in names and s.start_ns >= self.t0]

    def idle_inside(self, names) -> int:
        """Idle nanoseconds of the window while the host was inside a span
        named in ``names``: the gaps' overlap with the union of those spans."""
        covered, end = [], None
        for s0, s1 in sorted((s.start_ns, s.end_ns) for s in self.in_window(names)):
            if end is not None and s0 <= end:
                covered[-1] = (covered[-1][0], max(end, s1))
            else:
                covered.append((s0, s1))
            end = covered[-1][1]
        total, k = 0, 0
        for g0, g1 in self.gaps:  # both in time order
            while k < len(covered) and covered[k][1] <= g0:
                k += 1
            j = k
            while j < len(covered) and covered[j][0] < g1:
                total += min(g1, covered[j][1]) - max(g0, covered[j][0])
                j += 1
        return total


def of(ctx):
    """The run's span window, measured once and kept on ``ctx.spans``."""
    if not hasattr(ctx, "spans"):
        ctx.spans = measure(ctx.driver)
    return ctx.spans


def measure(first, seconds: float = SPAN_S) -> SpanWindow | None:
    """A span window over a new driver like ``first``; None where the program
    has no recorder or the window's outputs are not correct."""
    try:
        from repro_torch.kernels.work import Recorder
    except ImportError:
        return None
    device = first.device
    driver = type(first)(first.config, first.traffic, first.seed, device)
    driver.warmup()
    sw = span_window(driver, device, Recorder(device), seconds)
    driver.free()
    checks, failed = driver.check()
    report(sw, checks)
    limits = driver.traffic["limits"]
    if failed or any(checks[k] > limits[k] for k in limits):
        print(f"spans: the span window's outputs are not correct ({failed} failed); "
              "its metrics are left out", file=sys.stderr)
        return None
    return sw


def report(sw: SpanWindow, checks: dict) -> None:
    """The window, its spans' host ms and its idle by span, on standard error."""
    w = sw.trace.window
    idle = 100.0 * (1.0 - sw.trace.busy_s / w.wall_s)
    print(f"spans: {w.calls} calls in {w.wall_s:.3f} s, device idle {idle:.3f} %, "
          f"{len(sw.spans)} spans, counters {sw.counts}, checks {checks}", file=sys.stderr)
    for name in sorted({s.name for s in sw.spans}):
        ms = [(s.end_ns - s.start_ns) / 1e6 for s in sw.in_window({name})]
        if ms:
            q = np.percentile(ms, [50, 100])
            print(f"span {name}: {len(ms)} ms mean {np.mean(ms):.4f} p50 {q[0]:.4f} "
                  f"max {q[1]:.4f}", file=sys.stderr)
    print(f"idle_by_span {idle_by_span(sw)}", file=sys.stderr)


class _Clocked:
    """A driver whose calls note their start and end (``time.time_ns()``)."""

    def __init__(self, driver):
        self.driver, self.bounds = driver, []

    @property
    def done(self):
        return self.driver.done

    def call(self) -> int:
        t0 = time.time_ns()
        units = self.driver.call()
        self.bounds.append((t0, time.time_ns()))
        return units


def span_window(driver, device, recorder, seconds: float = SPAN_S) -> SpanWindow:
    """``traced_window`` as it is, for ``seconds``, inside ``recorder`` (a
    context manager that listens while entered); the device spans of its
    window are kept beside the recorder's, by wrapping ``trace._events``, the
    one place that sees them, for the call."""
    plain, kept = trace._events, []

    def keeping(prof):
        dev, host = plain(prof)
        kept.extend(dev)
        return dev, host

    clocked = _Clocked(driver)
    # the earlier windows' profilers leave millions of objects for the cyclic
    # collector; collected inside the window, they held one call for seconds
    gc.collect()
    trace._events = keeping
    try:
        with recorder:
            tr = trace.traced_window(clocked, seconds, device)
    finally:
        trace._events = plain
    return spans_over(tr, clocked.bounds[1:], kept, recorder.spans, recorder.counts)


def spans_over(tr: trace.Trace, bounds, dev, spans, counts) -> SpanWindow:
    """The span window of the calls that ran from ``bounds[0][0]`` to
    ``bounds[-1][1]``: its device idle intervals, each with its owner."""
    t0 = bounds[0][0]
    dev = [d for d in dev if d[0] >= t0]
    t1 = max([bounds[-1][1]] + [d[1] for d in dev])
    return SpanWindow(tr, t0, t1, *owned_gaps(dev, spans, t0, t1), spans, counts)


def owned_gaps(dev, spans, t0: int, t1: int) -> tuple[list, list]:
    """The intervals of [t0, t1] that no device span covers, and per interval
    the index of the innermost (shortest) span of ``spans`` holding its
    middle, -1 where none does."""
    _, gaps = trace._union_ns([(t0, t0, ""), *dev, (t1, t1, "")])
    order = sorted(range(len(spans)), key=lambda i: spans[i].start_ns)
    owners, stack, k = [], [], 0
    for g0, g1 in gaps:  # in time order: sweep the spans once
        mid = (g0 + g1) / 2
        while k < len(order) and spans[order[k]].start_ns <= mid:
            stack.append(order[k])
            k += 1
        stack = [i for i in stack if spans[i].end_ns >= mid]
        owners.append(
            min(stack, key=lambda i: spans[i].end_ns - spans[i].start_ns) if stack else -1
        )
    return gaps, owners


def idle_by_span(sw: SpanWindow) -> list[list]:
    """Device-idle milliseconds a call by the innermost program span holding
    each gap's middle (``OUTSIDE`` where none does), largest first."""
    by_name: dict[str, float] = {}
    for (g0, g1), i in zip(sw.gaps, sw.owners):
        name = sw.spans[i].name if i >= 0 else OUTSIDE
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0) / 1e6 / sw.trace.window.calls
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])]
