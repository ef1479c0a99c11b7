"""The frozen operation and byte counts, the roofline, ``mfu`` and idle
arithmetic, and the attribution of idle gaps, on hand-worked shapes."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from _perfbench_tiny import ROOT  # noqa: F401  (puts the harness on the path)

from perfbench import trace, work


def test_spike_matmul_work():
    # [3,4] shared spikes x [2,4,5] weights -> [2,3,5]: 12 + 40 + 30 int32
    assert work.spike_matmul_work(2, 3, 4, 5, True) == (4 * 82, 240)
    # each candidate's own spikes [2,3,4]: 24 + 40 + 30
    assert work.spike_matmul_work(2, 3, 4, 5, False) == (4 * 94, 240)


def test_lif_scan_work():
    # currents and spikes 2 x [2,3,4,5], the final membrane [2,4,5], 2 x [2] registers
    n_bytes, ops = work.lif_scan_work(2, 3, 4, 5, taps=7)
    assert n_bytes == 4 * (240 + 40 + 4)
    assert ops == 3 * 4 * 5 * (12 * 2 + 2 * 7)


def test_sparse_accum_work_counts_events_not_slots():
    # 7 events (value + index), a [4,3] table once, a [10,3] output
    assert work.sparse_accum_work(10, 7, 4, 3) == (8 * 7 + 4 * 12 + 4 * 30, 2 * 7 * 3)


def test_net_ops_per_sample():
    layers = [
        {"n_in": 256, "n_out": 128, "topology": "ata_f"},
        {"n_in": 128, "n_out": 10, "topology": "ff"},
    ]
    assert work.net_ops_per_sample(layers, 20) == 2 * 20 * (32768 + 128 + 1280)


def test_bound_takes_the_larger_term():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 1979e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 2 * 1979e12) == pytest.approx(2.0)


@pytest.mark.parametrize(
    "max_active, n_in, budget, sparse",
    [(0, 256, 16, True), (17, 256, 32, True), (80, 256, 80, True), (81, 256, 96, False),
     (250, 256, 256, False), (32, 128, 32, True), (43, 128, 48, False)],
)
def test_event_budget_rule(max_active, n_in, budget, sparse):
    assert work.event_budget(max_active, n_in) == budget
    assert work.takes_sparse_path(max_active, n_in) is sparse


def _ctx(kernels, planned, busy=1.0, wall=4.0, units=10, ops_per_unit=1.0):
    window = trace.Window(units=units, calls=2, wall_s=wall, call_s=[wall / 2] * 2)
    tr = trace.Trace(window, 0, 2, kernels, busy)
    driver = SimpleNamespace(
        launches=lambda first, last: planned, ops_per_unit=lambda: ops_per_unit
    )
    return SimpleNamespace(trace=tr, driver=driver, window=window)


def test_roofline_share_of_the_window_launches():
    kernels = {"void (anonymous namespace)::spike_matmul_kernel<16, true>(int)": (4.0, 2)}
    planned = {"spike_matmul_kernel": [(3.35e12, 0), (0, 1979e12)]}
    assert trace.roofline_pct(_ctx(kernels, planned), "spike_matmul_kernel") == pytest.approx(50)
    # the profiler's launches are not the driver's: nothing is read
    assert trace.roofline_pct(_ctx(kernels, {"spike_matmul_kernel": [(1, 1)]}), "spike_matmul_kernel") is None
    assert trace.roofline_pct(_ctx({}, planned), "spike_matmul_kernel") is None


def test_idle_and_mfu():
    ctx = _ctx({}, {}, busy=1.0, wall=4.0, units=10, ops_per_unit=1979e12 * 0.4)
    assert trace.idle_pct(ctx) == pytest.approx(75.0)
    assert trace.mfu_pct(ctx) == pytest.approx(100.0)


def test_union_and_gap_attribution():
    dev = [(0, 10, "a"), (20, 30, "b"), (25, 40, "c"), (50, 60, "d")]
    assert trace._union_ns(dev) == (40, [(10, 20), (40, 50)])
    host = [(5, 45, "outer"), (12, 18, "inner"), (70, 80, "later")]
    got = trace.attribute_gaps(dev, host, calls=2)
    assert got == [["inner", 5e-9], ["outer", 5e-9]]
    assert trace.attribute_gaps(dev, [], calls=1) == [["host Python", 2e-8]]


def test_timed_window_closes_with_the_call_in_flight():
    import time

    class Slow:
        done = []

        def call(self):
            time.sleep(0.05)
            return 3

    w = trace.timed_window(Slow(), 0.12, "cpu")
    assert w.calls == 3 and w.units == 9 and w.wall_s >= 0.12 and len(w.call_s) == 3
