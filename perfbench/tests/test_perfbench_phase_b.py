"""``phase_b_kernel_pct.dse``, the share of a sweep's layer windows whose
phase B ran as one kernel call, on the tiny sweep drivers of the CPU."""

from __future__ import annotations

import types

import pytest
from _perfbench_tiny import run, tiny
from test_perfbench_spans import _fake_traced_window, _trace

from perfbench import spans, trace
from perfbench.drivers import sweep as sweep_driver
from repro_torch.kernels import work as program_work

READ = run.reader("phase_b_kernel_pct.dse")
SWEEPS = [(c["config"], c["traffic"]) for c in run.spec()["workloads"]]


def _freed(pair):
    """A tiny sweep driver of ``pair`` after its run, as the readers find it."""
    _, _, config, traffic = tiny(pair)
    driver = sweep_driver.Driver(config, traffic, 2**31 + 13, "cpu")
    driver.warmup()
    driver.free()
    return driver


@pytest.mark.parametrize("pair", SWEEPS, ids=["-".join(p) for p in SWEEPS])
def test_every_layer_window_opens_a_kernel_span(pair, monkeypatch):
    monkeypatch.setattr(trace, "traced_window", _fake_traced_window)
    ctx = types.SimpleNamespace(driver=_freed(pair))
    assert READ(ctx) == 100.0
    assert len(ctx.spans.in_window({"population.sweep"})) == 2


def test_one_layer_window_of_two_on_the_step_loop(monkeypatch):
    """The ATA-F layer's window opening no kernel span, as where the
    program steps it in PyTorch: half the windows."""
    monkeypatch.setattr(trace, "traced_window", _fake_traced_window)
    plain = program_work.kernel
    monkeypatch.setattr(
        program_work, "kernel",
        lambda name, *a: program_work.OFF if name == "ataf_scan" else plain(name, *a),
    )
    ctx = types.SimpleNamespace(driver=_freed(("snn-mnist-lif-ataf", "sweep_p512")))
    assert READ(ctx) == 50.0


def test_nothing_without_a_span_window_or_its_sweeps():
    assert READ(types.SimpleNamespace(spans=None)) is None
    empty = spans.spans_over(_trace(1, 8), [(0, 10)], [], [], {})
    assert READ(types.SimpleNamespace(spans=empty)) is None
