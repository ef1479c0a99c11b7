"""The program's spans and counters (``repro_torch.kernels.work``).

On the CPU: the off path, the recorder's tree, ``spanned``, sinks that take
only kernel calls (the dry run's), the span trees of
``eval_int_population`` (an ATA-T layer's step loop too) and ``eval_int``.
On the card (``cuda`` marker, skipped here inside each test), with no JAX
imported:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tracing.py

spans and the profiler's device events on one clock, ``spike_matmul``'s
route counter against the multiply-adds its inputs must send down each
route (an ATA-T recurrence's counted apart), and outputs the same bit for
bit whether or not a recorder listens.
"""

from __future__ import annotations

import itertools
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.core.network import NetworkConfig, init_float_params, quantize_params
from repro_torch.core.shard import make_mesh
from repro_torch.core.snn_layer import LayerConfig, NeuronModel, Topology
from repro_torch.data.snn_datasets import SpikeDataset
from repro_torch.kernels import work
from repro_torch.kernels.quant_matmul.spike_matmul import (
    CHUNK,
    STRIP,
    plan,
    planes_fit,
    spike_matmul,
)
from repro_torch.snn.train import eval_int, eval_int_population


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class _KernelSink:
    """A sink with kernel methods only, as the dry run's ``StepCounter``."""

    def __init__(self):
        self.calls = []

    def kernel_begin(self, name, flops, nbytes, operands=()):
        self.calls.append(("begin", name, flops, nbytes, len(operands)))

    def kernel_end(self):
        self.calls.append(("end",))


def test_nothing_listening_gives_the_shared_no_op():
    assert work.span("population.sweep") is work.OFF
    assert work.kernel("spike_matmul", 1, 2) is work.OFF
    assert work.device_counter("spike_matmul.macs", torch.device("cpu")) is None
    with work.span("a") as got:
        pass
    assert got is None
    rec = work.Recorder()  # made but never entered: it hears nothing
    with work.span("b"):
        spike_matmul(torch.ones(3, 4, dtype=torch.int32), torch.ones(4, 2, dtype=torch.int32))
    assert list(work.spanned(iter("xyz"), "c")) == ["x", "y", "z"]
    assert rec.spans == [] and rec.counts == {}


def test_recorder_tree_parents_calls_and_self_times(monkeypatch):
    clock = itertools.count(0, 10)
    monkeypatch.setattr(work, "time", types.SimpleNamespace(time_ns=lambda: next(clock)))
    with work.Recorder() as rec:
        with work.span("root"):  # 0 .. 90
            with work.span("a"):  # 10 .. 40
                with work.kernel("k", 6, 8):  # 20 .. 30
                    pass
            with work.span("b"):  # 50 .. 80
                with work.span("c"):  # 60 .. 70
                    pass
        with work.span("root2"):  # 100 .. 110
            pass
    got = [(s.name, s.start_ns, s.end_ns, s.parent) for s in rec.spans]
    assert got == [
        ("root", 0, 90, -1),
        ("a", 10, 40, 0),
        ("k", 20, 30, 1),
        ("b", 50, 80, 0),
        ("c", 60, 70, 3),
        ("root2", 100, 110, -1),
    ]
    # each span's self time (its duration less its children's) is what the
    # tree leaves it: children lie inside their parent and do not overlap
    self_ns = [s.end_ns - s.start_ns for s in rec.spans]
    for s in rec.spans:
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            self_ns[s.parent] -= s.end_ns - s.start_ns
    assert self_ns == [90 - 30 - 30, 30 - 10, 10, 30 - 10, 10, 10]
    assert rec.counts == {}  # no device counter off the card
    assert work.span("after") is work.OFF  # leaving stops the listening


def test_spanned_puts_each_step_of_an_iterator_in_a_span(monkeypatch):
    clock = itertools.count(0, 10)
    monkeypatch.setattr(work, "time", types.SimpleNamespace(time_ns=lambda: next(clock)))

    def items():
        yield 1
        yield 2

    with work.Recorder() as rec:
        with work.span("outer"):  # 0 .. 70
            got = [x for x in work.spanned(items(), "step")]
    assert got == [1, 2]
    # two steps that yield and the one that ends the iteration, each a child of outer
    assert [(s.name, s.start_ns, s.end_ns, s.parent) for s in rec.spans] == [
        ("outer", 0, 70, -1),
        ("step", 10, 20, 0),
        ("step", 30, 40, 0),
        ("step", 50, 60, 0),
    ]
    with work.Recorder() as rec:
        assert list(work.spanned([], "step")) == []
    assert [s.name for s in rec.spans] == ["step"]


def test_a_sink_without_span_methods_sees_the_kernel_calls_as_before():
    s, w = torch.ones(5, 4, dtype=torch.int32), torch.ones(4, 3, dtype=torch.int32)
    alone = _KernelSink()
    with work.listening(alone):
        with work.span("outer"):
            spike_matmul(s, w)
    beside = _KernelSink()
    with work.listening(beside), work.Recorder() as rec:
        with work.span("outer"):
            spike_matmul(s, w)
    want = [("begin", "spike_matmul", 2 * 5 * 4 * 3, 4 * (20 + 12 + 15), 2), ("end",)]
    assert alone.calls == beside.calls == want
    assert [(x.name, x.parent) for x in rec.spans] == [("outer", -1), ("spike_matmul", 0)]


def _tiny_net(T=4):
    layers = (
        LayerConfig(n_in=12, n_out=8, neuron=NeuronModel.LIF, topology=Topology.ATA_F),
        LayerConfig(n_in=8, n_out=3, neuron=NeuronModel.LIF, topology=Topology.FF),
    )
    return NetworkConfig(layers=layers, n_steps=T, name="tiny")


def _tiny_data(n=10, T=4, seed=0):
    rng = np.random.default_rng(seed)
    spikes = (rng.random((n, T, 12)) < 0.3).astype(np.uint8)
    return SpikeDataset(spikes, rng.integers(0, 3, n).astype(np.int32), 3, "tiny")


def _tree(rec):
    """Each outermost span as (name, [children as trees])."""
    kids = {i: [] for i in range(len(rec.spans))}
    for i, s in enumerate(rec.spans):
        if s.parent >= 0:
            kids[s.parent].append(i)

    def tree(i):
        return (rec.spans[i].name, [tree(k) for k in kids[i]])

    return [tree(i) for i, s in enumerate(rec.spans) if s.parent < 0]


@pytest.mark.parametrize("shards", [None, 2])
def test_population_sweep_records_its_span_tree(shards):
    net = _tiny_net()
    params = init_float_params(torch.Generator().manual_seed(0), net, device="cpu")
    cands = [net.replace_precisions(w_bits=b, w_rec_bits=b, leak_bits=3) for b in (3, 5, 9)]
    qps = [quantize_params(c, params)[0] for c in cands]
    ds = _tiny_data()
    mesh = None if shards is None else make_mesh(shards, devices=["cpu"] * shards)
    with work.Recorder("cpu") as rec:
        accs, stats = eval_int_population(
            net, cands, qps, ds, batch_size=4, return_stats=True, mesh=mesh
        )
    # the ATA-F layer: its currents and its scan; the FF layer: the same
    layer = lambda scan: [("spike_matmul", []), (scan, [])]
    kernels = (layer("ataf_scan") + layer("lif_scan")) * (shards or 1)
    batch = (
        "population.batch",
        [
            ("population.h2d", []),
            ("population.forward", kernels),
            ("population.readback", []),
        ],
    )
    assert _tree(rec) == [
        (
            "population.sweep",
            [("population.check", []), ("population.stack", [])]
            + [batch] * 3  # 10 samples in batches of 4
            + [("population.stats", [])],
        )
    ]
    assert rec.counts == {}  # the CPU keeps no device counter
    assert all(s.end_ns >= s.start_ns > 0 for s in rec.spans)
    # the same answers with nothing listening
    again = eval_int_population(net, cands, qps, ds, batch_size=4, return_stats=True, mesh=mesh)
    np.testing.assert_array_equal(accs, again[0])


def _tiny_rec_net(T=4):
    layers = (
        LayerConfig(n_in=12, n_out=8, neuron=NeuronModel.LIF, topology=Topology.ATA_T),
        LayerConfig(n_in=8, n_out=3, neuron=NeuronModel.LIF, topology=Topology.FF),
    )
    return NetworkConfig(layers=layers, n_steps=T, name="tiny-rec")


def _precision_population(net, device="cpu", bits=(3, 5, 9)):
    params = init_float_params(torch.Generator().manual_seed(2), net, device=device)
    cands = [net.replace_precisions(w_bits=b, w_rec_bits=b, leak_bits=3) for b in bits]
    return cands, [quantize_params(c, params)[0] for c in cands]


def test_an_ata_t_layer_steps_inside_one_step_loop_span_a_batch():
    net = _tiny_rec_net()
    cands, qps = _precision_population(net)
    with work.Recorder("cpu") as rec:
        eval_int_population(net, cands, qps, _tiny_data(), batch_size=4, return_stats=True)
    # the ATA-T layer: its currents, then T recurrence products in its step
    # loop; the FF layer: its currents and its scan
    forward = (
        "population.forward",
        [
            ("spike_matmul", []),
            ("population.step_loop", [("spike_matmul", [])] * net.n_steps),
            ("spike_matmul", []),
            ("lif_scan", []),
        ],
    )
    batches = [kids for name, kids in _tree(rec)[0][1] if name == "population.batch"]
    assert len(batches) == 3 and all(forward in kids for kids in batches)
    assert sum(s.name == "population.step_loop" for s in rec.spans) == 3
    # a sweep with FF and ATA-F layers only opens none
    net = _tiny_net()
    cands, qps = _precision_population(net)
    with work.Recorder("cpu") as rec:
        eval_int_population(net, cands, qps, _tiny_data(), batch_size=4)
    assert not any(s.name == "population.step_loop" for s in rec.spans)


def test_eval_int_records_its_spans():
    net = _tiny_net()
    params = init_float_params(torch.Generator().manual_seed(1), net, device="cpu")
    qparams = quantize_params(net, params)[0]
    ds = _tiny_data(n=7)
    with work.Recorder("cpu") as rec:
        acc, _ = eval_int(net, qparams, ds, batch_size=3, return_stats=True, backend="fused")
    # 7 samples in batches of 3: a gather, a copy and the forward's kernels a
    # batch (the ATA-F layer a step at a time, T = 4, then the FF layer's
    # currents and scan), and the gather that ends the batches
    kernels = [("spike_matmul", [])] * 5 + [("lif_scan", [])]
    batch = [("eval.gather", []), ("eval.h2d", [])] + kernels
    assert _tree(rec) == batch * 3 + [("eval.gather", [])]
    assert acc == eval_int(net, qparams, ds, batch_size=3, backend="fused")
    with work.Recorder("cpu") as empty:
        eval_int(net, qparams, _tiny_data(n=0), batch_size=3)
    assert _tree(empty) == [("eval.gather", [])]


# --- on the card ----------------------------------------------------------


ROUTES = ("tensor", "planes", "cuda_cores")


def _expected_macs(s: np.ndarray, w: np.ndarray) -> list[int]:
    """[tensor, planes, cuda_cores] multiply-adds of ``s`` [P, M, K] @ ``w``
    [P, K, N] by the kernel's rules: where every weight of a block's slice
    fits int8, each 16-row strip's 256-deep chunk runs in one pass where
    every spike of it fits int8, else in byte planes; where they fit int16
    (and the high plane fits the block), a chunk whose spikes fit int8 runs
    in the two weight planes, a graded one on the CUDA cores; wider weights
    run on the CUDA cores.  A tile counts its rows, depth and columns inside
    [M, K, N]."""
    P, M, K = s.shape
    N = w.shape[2]
    p = plan(M, K, N, P if P > 1 else 1)
    fits = lambda a: bool(np.all((a >= -128) & (a <= 127)))
    fits16 = lambda a: bool(np.all((a >= -(2**15)) & (a < 2**15)))
    out = [0, 0, 0]
    n_chunks = max(1, -(-K // CHUNK))
    for c in range(P):
        for j in range(p.grid[1]):
            cols = slice(j * p.bn, (j + 1) * p.bn)
            w8 = p.kind == "tensor" and fits(w[c][:, cols])
            w16 = p.kind == "tensor" and planes_fit(K, p.bn) and fits16(w[c][:, cols])
            for r in range(0, M, STRIP):
                for k in range(n_chunks):
                    tile = s[c][r : r + STRIP, k * CHUNK : (k + 1) * CHUNK]
                    macs = tile.size * w[c][0, cols].size
                    if w8:
                        route = 0 if fits(tile) else 1
                    else:
                        route = 1 if w16 and fits(tile) else 2
                    out[route] += macs
    assert sum(out) == P * M * K * N
    return out


def _population(seed=0, P=6, M=100, K=300, N=128):
    """Candidate 0 narrow with binary spikes, 1 with int16 weights, 2 with
    graded spikes everywhere, 3 with one graded spike (row 0, chunk 0), 4
    with weights beyond int16, 5 with int16 weights and two graded spikes
    (rows 0 and 50, chunk 0)."""
    rng = np.random.default_rng(seed)
    s = (rng.random((P, M, K)) < 0.2).astype(np.int32)
    w = rng.integers(-8, 8, (P, K, N)).astype(np.int32)
    w[1] = rng.integers(-2000, 2000, (K, N))
    s[2] = np.where(s[2] > 0, 300, 0)
    s[2][:, 0] = 300  # every row of every chunk holds a graded value
    s[2][:, CHUNK] = 300
    s[3][0, 0] = 1000
    w[4] = rng.integers(-(2**20), 2**20, (K, N))
    w[5] = rng.integers(-2000, 2000, (K, N))
    s[5][0, 0], s[5][50, 3] = 1000, 200
    return s, w


def _run_counted(s, w, device):
    st, wt = torch.from_numpy(s).to(device), torch.from_numpy(w).to(device)
    with work.Recorder(device) as rec:
        out = spike_matmul(st, wt)
    return out, [rec.counts[f"spike_matmul.macs.{r}"] for r in ROUTES]


def test_expected_macs_follow_the_kernels_rules():
    s, w = _population()
    mkn = 100 * 300 * 128  # one candidate's multiply-adds
    graded = STRIP * CHUNK * 128  # one graded tile (candidate 3's, candidate 5's two)
    assert _expected_macs(s, w) == [2 * mkn - graded, 3 * mkn - graded, mkn + 2 * graded]


@pytest.mark.cuda
def test_route_counter_counts_each_route(cuda):
    s, w = _population()
    mkn, graded = 100 * 300 * 128, STRIP * CHUNK * 128
    out, macs = _run_counted(s, w, cuda)
    assert macs == [2 * mkn - graded, 3 * mkn - graded, mkn + 2 * graded]
    # a shared raster ([M, K] @ [P, K, N]) and single products with several column blocks
    for s2, w2 in [
        (s[0], w),
        (s[3][:40, :64], w[0][:64, :24]),
        (s[0][:40], np.concatenate([w[0], w[1][:, :72]], axis=1)),
    ]:
        out2, got = _run_counted(s2, w2, cuda)
        s3 = np.broadcast_to(s2, (w2.shape[0],) + s2.shape) if w2.ndim == 3 else s2[None]
        assert got == _expected_macs(np.ascontiguousarray(s3), w2 if w2.ndim == 3 else w2[None])


@pytest.mark.cuda
def test_outputs_are_the_same_with_and_without_a_recorder(cuda):
    s, w = _population(seed=3)
    st, wt = torch.from_numpy(s).to(cuda), torch.from_numpy(w).to(cuda)
    plain = spike_matmul(st, wt)
    counted, _ = _run_counted(s, w, cuda)
    assert torch.equal(plain, counted)
    ref = (s.astype(np.int64) @ w.astype(np.int64)).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(plain.cpu().numpy(), ref)


@pytest.mark.cuda
def test_spans_hold_their_device_events_on_one_clock(cuda):
    from torch.profiler import ProfilerActivity, profile

    s = torch.from_numpy((np.random.default_rng(0).random((4620, 256)) < 0.1).astype(np.int32))
    w = np.random.default_rng(1).integers(-30, 30, (64, 256, 128)).astype(np.int32)
    w = torch.from_numpy(w)
    s, w = s.to(cuda), w.to(cuda)
    spike_matmul(s, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):  # a profiler opened cold can miss the first launches
            spike_matmul(s, w)
        torch.cuda.synchronize()
        time.sleep(0.02)
        with work.Recorder(cuda) as rec:
            for _ in range(100):
                with work.span("call"):
                    spike_matmul(s, w)
                    torch.cuda.synchronize()
    calls = [x for x in rec.spans if x.name == "call"]
    events = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and "spike_matmul_kernel" in e.name()
        and e.start_ns() >= calls[0].start_ns
    )
    assert len(calls) == len(events) == 100
    # how far each device event reaches outside its span (negative: inside)
    offsets = [max(c.start_ns - e0, e1 - c.end_ns) for c, (e0, e1) in zip(calls, events)]
    print(f"largest offset {max(offsets)} ns (negative: every event inside its span)")
    assert max(offsets) < 0


@pytest.mark.cuda
def test_the_recurrence_counts_apart_from_the_feed_forward_products(cuda):
    net = _tiny_rec_net(T=6)
    cands, qps = _precision_population(net, device=cuda, bits=(3, 8, 12, 16))
    ds = _tiny_data(n=10, T=6)
    with work.Recorder(cuda) as rec:
        accs, stats = eval_int_population(net, cands, qps, ds, batch_size=10, return_stats=True)
    P, B, T = len(cands), 10, net.n_steps
    ff = sum(P * T * B * cfg.n_in * cfg.n_out for cfg in net.layers)
    rec_macs = [rec.counts[f"spike_matmul.rec_macs.{r}"] for r in ROUTES]
    assert sum(rec_macs) == P * B * 8 * 8 * T
    assert sum(rec.counts[f"spike_matmul.macs.{r}"] for r in ROUTES) == ff
    # the same answers as the CPU's
    cands_cpu, qps_cpu = _precision_population(net, bits=(3, 8, 12, 16))
    want = eval_int_population(net, cands_cpu, qps_cpu, ds, batch_size=10, return_stats=True)
    np.testing.assert_array_equal(accs, want[0])
    for got, exp in zip(stats, want[1]):
        for a, b in zip(got["layer_events_per_step"], exp["layer_events_per_step"]):
            np.testing.assert_array_equal(a, b)
