"""The measured window, the profiler's view of it, and what readers take from it.

A timed window runs a driver's calls back to back for ``seconds`` of the host
clock and closes at the end of the call in flight then, so that no call is cut
off; a rate divides every unit of the window by all of its time.  A traced window runs the same loop under
``torch.profiler`` (device activity only), after one warm-up step inside the
profiler and a wait of ``SETTLE_S`` (a profiler opened cold around a call was
seen to miss that call's first launches); every call of it is recorded.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from perfbench import work

SETTLE_S = 0.02


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    units: int  # units of every call made
    calls: int
    wall_s: float  # start of the first call to the end of the last
    call_s: list  # each call's seconds


def timed_window(driver, seconds: float, device) -> Window:
    """Calls back to back until one ends at or after ``seconds``: the window
    closes with the call in flight, so no call is cut off."""
    t0 = time.perf_counter()
    units, ends = 0, [t0]
    while True:
        units += driver.call()
        _sync(device)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            return Window(units, len(ends) - 1, ends[-1] - t0, list(np.diff(ends)))


@dataclasses.dataclass
class Trace:
    window: Window
    first: int  # index of the first traced call in ``driver.done``
    last: int  # one past the last
    kernels: dict[str, tuple[float, int]]  # device op -> (seconds, launches)
    busy_s: float  # the union of the device ops' spans in the window

    def time_of(self, part: str) -> tuple[float, int]:
        """Seconds and launches of the device ops whose name holds ``part``."""
        hits = [v for k, v in self.kernels.items() if part in k]
        return sum(s for s, _ in hits), sum(n for _, n in hits)


def _events(prof):
    """(device spans as (start_ns, end_ns, name), host spans likewise) of a
    finished profiler, straight from its Kineto results."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(span)
    return dev, host


def _union_ns(spans) -> tuple[int, list[tuple[int, int]]]:
    """Nanoseconds covered by the spans, and the gaps between them."""
    total, gaps, end = 0, [], None
    for s, e, _ in sorted(spans):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def traced_window(driver, seconds: float, device) -> Trace:
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = [ProfilerActivity.CUDA]
    sched = schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=cuda, schedule=sched) as prof:
        driver.call()
        _sync(device)
        prof.step()
        time.sleep(SETTLE_S)
        first = len(driver.done)
        t0 = time.time_ns()
        window = timed_window(driver, seconds, device)
        t1 = time.time_ns()
        prof.step()
    dev = [d for d in _events(prof)[0] if t0 <= d[0] <= t1]
    kernels: dict[str, tuple[float, int]] = {}
    for s, e, name in dev:
        sec, n = kernels.get(name, (0.0, 0))
        kernels[name] = (sec + (e - s) / 1e9, n + 1)
    return Trace(window, first, len(driver.done), kernels, _union_ns(dev)[0] / 1e9)


def idle_gaps(driver, device, calls: int = 2, top: int = 10) -> list[list]:
    """Idle seconds a call between device operations, by the innermost host
    operation running at each gap's middle ("host Python" where none is),
    over ``calls`` calls profiled with host activity too."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            driver.call()
            _sync(device)
    return attribute_gaps(*_events(prof), calls, top)


def attribute_gaps(dev, host, calls: int, top: int = 10) -> list[list]:
    """The gaps between the device spans, in seconds a call, summed by the
    innermost host span (start_ns, end_ns, name) holding each gap's middle."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    by_name: dict[str, float] = {}
    stack, i = [], 0
    for g0, g1 in _union_ns(dev)[1]:  # gaps in time order: sweep the host spans once
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        stack = [h for h in stack if h[1] >= mid]
        name = min(stack, key=lambda h: h[1] - h[0])[2] if stack else "host Python"
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0) / 1e9 / calls
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


# --- what the per-layer readers share ---------------------------------------


def idle_pct(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window.wall_s)


def mfu_pct(ctx):
    w = ctx.trace.window
    ops = ctx.driver.ops_per_unit() * w.units
    return 100.0 * ops / w.wall_s / work.INT8_TC_OPS_S


def roofline_pct(ctx, kernel: str):
    """Sum of the bounds over sum of device time of ``kernel``'s launches in
    the traced window; nothing where the window has none, or where the
    profiler's launches are not the driver's."""
    seconds, n = ctx.trace.time_of(kernel)
    planned = ctx.driver.launches(ctx.trace.first, ctx.trace.last).get(kernel, [])
    print(f"trace: {kernel} launches: profiler {n}, driver {len(planned)}", file=sys.stderr)
    if not n or n != len(planned):
        return None
    return 100.0 * sum(work.bound_s(b, o) for b, o in planned) / seconds
