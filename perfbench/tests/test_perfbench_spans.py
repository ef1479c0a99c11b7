"""The span window and the readers of the program's spans and counters, on
synthetic spans and device events; the kernels' reported work against the
frozen counts of ``perfbench/work.py`` at the cells' shapes."""

from __future__ import annotations

import types

import pytest
import torch
from _perfbench_tiny import CELLS, run, tiny

from perfbench import program, spans, trace, work
from perfbench.drivers import sweep as sweep_driver
from perfbench.drivers import infer as infer_driver
from repro_torch.kernels import work as program_work
from repro_torch.kernels.lif_scan.lif_scan import lif_scan
from repro_torch.kernels.quant_matmul.spike_matmul import spike_matmul

Span = program_work.Span
READERS = [
    "stack_host_ms.dse",
    "forward_idle_ms.dse",
    "spike_matmul_cuda_core_pct.dse",
    "gather_host_ms.infer",
]


class _Taken(Exception):
    pass


class _Take:
    """Keeps a kernel call's reported work and stops the call there."""

    def kernel_begin(self, name, flops, nbytes, operands=()):
        self.got = (name, nbytes, flops)
        raise _Taken


def _reported(fn, *args, **kw):
    sink = _Take()
    with program_work.listening(sink), pytest.raises(_Taken):
        fn(*args, **kw)
    return sink.got


def _big(*shape):
    """An int32 tensor of ``shape`` that holds one element."""
    return torch.zeros(1, dtype=torch.int32).expand(*shape)


@pytest.mark.parametrize("cell_name", CELLS)
def test_kernels_report_the_frozen_work_at_the_cells_shapes(cell_name):
    bench = run.spec()
    cell = run.cell_of(bench, cell_name)
    config = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    P = traffic["population"] or len(program.space(config, traffic["max_bits"]))
    T, B = config["network"]["n_steps"], traffic["samples"]
    M = T * B
    for li, layer in enumerate(config["network"]["layers"]):
        K, N = layer["n_in"], layer["n_out"]
        s = _big(M, K) if li == 0 else _big(P, M, K)
        nbytes, ops = work.spike_matmul_work(P, M, K, N, li == 0)
        assert _reported(spike_matmul, s, _big(P, K, N)) == ("spike_matmul", nbytes, ops)
        if layer["topology"] == "ff":
            regs = torch.zeros(P, dtype=torch.int32)
            got = _reported(lif_scan, _big(P, T, B, N), theta_q=regs, decay_k=regs)
            # the taps' shift-adds are left out of the program's count
            assert got == ("lif_scan",) + work.lif_scan_work(P, T, B, N, taps=0)


def _trace(calls: int, units: int, wall_s: float = 1.0, busy_s: float = 0.5) -> trace.Trace:
    return trace.Trace(trace.Window(units, calls, wall_s, []), 0, calls, {}, busy_s)


def _sweep_spans():
    """Two sweeps over [100, 280) and [300, 480); a warm-up sweep before."""
    spans = [Span("population.sweep", 0, 90, -1), Span("population.stack", 10, 30, 0)]
    for lo in (100, 300):
        r = len(spans)
        spans += [
            Span("population.sweep", lo, lo + 180, -1),
            Span("population.stack", lo + 10, lo + 40, r),  # 30 ns
            Span("population.batch", lo + 50, lo + 170, r),
            Span("population.forward", lo + 60, lo + 120, r + 2),
            Span("spike_matmul", lo + 60, lo + 64, r + 3),
            Span("population.readback", lo + 120, lo + 170, r + 2),
        ]
    return spans


def _sweep_window(counts=None):
    dev = [(20, 80, "warm-up")]
    for lo in (100, 300):  # busy on [lo+30, lo+35), [lo+70, lo+75) and [lo+130, lo+160)
        dev += [(lo + 30, lo + 35, "k"), (lo + 70, lo + 75, "k"), (lo + 130, lo + 160, "k")]
    bounds = [(100, 280), (300, 490)]
    return spans.spans_over(_trace(2, 2 * 8), bounds, dev, _sweep_spans(), counts or {})


def test_owned_gaps_and_idle_by_span():
    sw = _sweep_window()
    assert (sw.t0, sw.t1) == (100, 490)
    assert sw.gaps == [
        (100, 130), (135, 170), (175, 230), (260, 330), (335, 370), (375, 430), (460, 490)
    ]
    names = [sw.spans[i].name if i >= 0 else spans.OUTSIDE for i in sw.owners]
    assert names == [
        "population.stack", "population.batch", "population.forward", spans.OUTSIDE,
        "population.batch", "population.forward", "population.sweep",
    ]
    got = dict(spans.idle_by_span(sw))  # ms a call, over 2 calls
    assert got == pytest.approx({
        "population.stack": 15e-6, "population.batch": 35e-6, "population.forward": 55e-6,
        spans.OUTSIDE: 35e-6, "population.sweep": 15e-6,
    })
    assert list(got)[0] == "population.forward"  # largest first


def _ctx(sw):
    return types.SimpleNamespace(spans=sw)


def test_the_readers_of_the_sweep_spans():
    macs = {"tensor": 30, "planes": 10, "cuda_cores": 60}
    sw = _sweep_window({f"spike_matmul.macs.{r}": n for r, n in macs.items()})
    got = {name: run.reader(name)(_ctx(sw)) for name in READERS}
    assert got["stack_host_ms.dse"] == pytest.approx(30e-6)  # the warm-up's stack left out
    # the gaps' overlap with [100, 280) and [300, 480): all but [280, 300) and [480, 490)
    assert sw.idle_inside({"population.sweep"}) == 280
    # with [160, 220) and [360, 420): [160, 170), [175, 220), [360, 370), [375, 420)
    assert sw.idle_inside({"population.forward"}) == 110
    assert got["forward_idle_ms.dse"] == pytest.approx(55e-6)
    assert got["spike_matmul_cuda_core_pct.dse"] == pytest.approx(60.0)
    assert got["gather_host_ms.infer"] is None
    idle_per_call = 1e-6 * sum(g1 - g0 for g0, g1 in sw.gaps) / 2
    assert got["forward_idle_ms.dse"] <= 1e-6 * 140 <= idle_per_call


def test_the_readers_find_nothing_where_the_program_has_no_spans():
    for name in READERS:
        assert run.reader(name)(_ctx(None)) is None
    parts = ("tensor", "planes", "cuda_cores")
    for counts, want in [({}, None), (dict.fromkeys(parts, 0), None), ({"tensor": 7}, None),
                         ({"tensor": 7, "planes": 0, "cuda_cores": 0}, 0.0)]:
        sw = spans.spans_over(_trace(1, 8), [(0, 10)], [], [], {
            f"spike_matmul.macs.{k}": n for k, n in counts.items()
        })
        assert run.reader("spike_matmul_cuda_core_pct.dse")(_ctx(sw)) == want
        for name in READERS[:2] + READERS[3:]:
            assert run.reader(name)(_ctx(sw)) is None


class _Event:
    def __init__(self, s, e, name):
        self.s, self.e, self.n = s, e, name

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def name(self):
        return self.n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA


def _fake_traced_window(driver, seconds, device):
    """``traced_window`` on the CPU: a warm-up call and two window calls, with
    one device event a window call read from a made-up profiler."""
    assert program_work.span("x") is not program_work.OFF  # the recorder listens
    units = [driver.call() for _ in range(3)]
    events = [_Event(t0 + 1, t0 + 2, "k") for t0, _ in driver.bounds[1:]]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    dev, _ = trace._events(prof)
    assert dev == [(e.s, e.e, "k") for e in events]
    return _trace(2, sum(units[1:]))


def test_span_window_runs_the_traced_window_inside_the_recorder(monkeypatch):
    plain_events = trace._events

    class Driver:
        done = []

        def call(self):
            with program_work.span("population.sweep"):
                pass
            self.done.append(None)
            return 4

    monkeypatch.setattr(trace, "traced_window", _fake_traced_window)
    sw = spans.span_window(Driver(), "cpu", program_work.Recorder("cpu"), seconds=0.1)
    assert trace._events is plain_events  # put back
    assert program_work.span("x") is program_work.OFF  # the recorder left
    assert [s.name for s in sw.spans] == ["population.sweep"] * 3
    assert len(sw.in_window({"population.sweep"})) == 2
    assert sw.gaps[0] == (sw.t0, sw.t0 + 1)


def _freed_sweep_driver(limits=None):
    """A tiny sweep driver after its run, as the readers find it."""
    _, _, config, traffic = tiny(("snn-mnist-lif-ataf", "sweep_int8_p256"))
    traffic["limits"].update(limits or {})
    driver = sweep_driver.Driver(config, traffic, 2**31 + 13, "cpu")
    driver.warmup()
    driver.free()
    return driver


def test_the_span_window_is_measured_once_on_a_new_driver(monkeypatch):
    monkeypatch.setattr(trace, "traced_window", _fake_traced_window)
    first = _freed_sweep_driver()
    ctx = types.SimpleNamespace(driver=first)
    sw = spans.of(ctx)
    assert first.done == [] and first.qps is None  # the run's driver is left as it was
    assert spans.of(ctx) is sw and ctx.spans is sw
    # two window sweeps of 8 candidates, each with its stack and its forward
    assert sw.trace.window.units == 16
    assert len(sw.in_window({"population.sweep"})) == 2
    assert len(sw.in_window({"population.stack"})) == 2
    assert len(sw.in_window({"population.forward"})) == 2
    for name in READERS[:2]:
        assert run.reader(name)(ctx) is not None, name
    # no device counters on the CPU
    assert run.reader("spike_matmul_cuda_core_pct.dse")(ctx) is None


def test_no_span_window_where_its_outputs_are_not_correct(monkeypatch):
    monkeypatch.setattr(trace, "traced_window", _fake_traced_window)
    ctx = types.SimpleNamespace(driver=_freed_sweep_driver({"event_gap": -1.0}))
    assert all(run.reader(name)(ctx) is None for name in READERS)
    assert ctx.spans is None


def test_no_span_window_where_the_program_has_no_recorder(monkeypatch):
    monkeypatch.delattr(program_work, "Recorder")

    class NotADriver:
        def __getattr__(self, name):
            raise AssertionError(f"read {name}")

    ctx = types.SimpleNamespace(driver=NotADriver())
    assert all(run.reader(name)(ctx) is None for name in READERS)


def test_gather_host_ms_reads_the_infer_drivers_spans():
    bench, cell, config, traffic = tiny(("snn-mnist-lif-ff", "infer_10k"))
    driver = infer_driver.Driver(config, traffic, 2**31 + 9, "cpu")
    driver.warmup()
    clocked = spans._Clocked(driver)
    with program_work.Recorder("cpu") as rec:
        units = sum(clocked.call() for _ in range(3))
    sw = spans.spans_over(_trace(2, units - traffic["samples"]), clocked.bounds[1:], [],
                          rec.spans, rec.counts)
    got = run.reader("gather_host_ms.infer")(_ctx(sw))
    host = [s for s in sw.in_window({"eval.gather", "eval.h2d"})]
    # two calls of 16 samples in batches of 6: 3 batches each, a gather and a
    # copy a batch, and the gather that ends the batches
    assert len(host) == 2 * (2 * 3 + 1)
    want = 1e-6 * sum(s.end_ns - s.start_ns for s in host) / ((units - traffic["samples"]) / 1e3)
    assert got == pytest.approx(want) and got > 0
    assert all(run.reader(n)(_ctx(sw)) is None for n in READERS if n.endswith(".dse"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_traced_cells_report_the_span_metrics_on_the_card(cell_name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    measured, plain = [], spans.measure
    monkeypatch.setattr(spans, "measure", lambda first: measured.append(plain(first)) or measured[-1])
    bench = run.spec()
    result, _ = run.run_cell(bench, run.cell_of(bench, cell_name), 2**31 + 11, 1.0, True, "cuda")
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"]
    for name in READERS[:3]:
        assert name in m, name
    assert len(measured) == 1  # one span window, shared by the readers
    idle = spans.idle_by_span(measured[0])
    assert idle
    # the card's idle inside the forward is part of its idle inside the sweep call
    assert 0 <= m["forward_idle_ms.dse"] <= sum(v for k, v in idle if k != spans.OUTSIDE) + 1e-3
    if cell_name == "mnist-ataf.sweep_narrow":
        assert m["spike_matmul_cuda_core_pct.dse"] == 0
