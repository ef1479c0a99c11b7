"""The plain reference of nets with a dense recurrent (ATA-T) core against the
port, and the ``sweep_rec`` driver, at small sizes on the CPU.

``reference_rec.py`` re-derives both quantized matrices of an ATA-T layer
and steps its recurrence in float64; through the port's plain CPU paths
(``quantize_params``, ``run_int``, ``eval_int_population``) the two agree
exactly.  The control (both matrices one bit coarser) and a program that
leaves the recurrence out both fail the limits; a net without an ATA-T layer
gets ``reference.py``'s answer.
"""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch
from _perfbench_tiny import ROOT, run, tiny

from perfbench import data, program, reference, reference_rec
from perfbench.drivers import sweep_rec
from repro_torch.core.network import quantize_params, run_int
from repro_torch.data.snn_datasets import SpikeDataset
from repro_torch.kernels import work as program_work
from repro_torch.snn.train import eval_int_population

CANDS = [(6, 2, 8), (6, 8, 3), (6, 16, 8), (12, 2, 3), (12, 8, 8), (12, 16, 3), (16, 16, 1), (3, 8, 5)]
T, N_SAMPLES = 5, 12


def _small_config():
    """The ATA-T configuration cut to 24 -> 12 (ATA-T) -> 4 at T = 5."""
    config = run.load_json(run.HERE / "configs" / "snn-mnist-lif-atat.json")
    config["network"]["n_steps"] = T
    l0, l1 = config["network"]["layers"]
    l0.update(n_in=24, n_out=12)
    l1.update(n_in=12, n_out=4)
    return config


def _weights(config, seed=7):
    layers = config["network"]["layers"]
    rec = iter(sweep_rec.recurrent_weights(seed, layers, "cpu"))
    return [
        (w_ff, next(rec) if l["topology"] == "ata_t" else w_rec, theta)
        for l, (w_ff, w_rec, theta) in zip(layers, data.float_weights(seed, layers, "cpu"))
    ]


def _rasters(seed=3, n=N_SAMPLES, n_in=24):
    rng = np.random.default_rng(seed)
    spikes = (rng.random((n, T, n_in)) < 0.3).astype(np.uint8)
    return spikes, rng.integers(0, 4, n).astype(np.int32)


def _program_qps(config, weights, cands):
    net = program.network(config)
    nets = [program.candidate(net, c) for c in cands]
    return net, nets, [quantize_params(c, program.float_params(weights))[0] for c in nets]


def test_quantize_equals_the_ports_quantize_params():
    config = _small_config()
    layers = config["network"]["layers"]
    weights = _weights(config)
    qs = reference_rec.quantize(layers, weights, CANDS)
    _, _, qps = _program_qps(config, weights, CANDS)
    assert qs[0].w_rec.shape == (len(CANDS), 12, 12)
    for c, got in enumerate(qps):
        for q, p in zip(qs, got):
            assert torch.equal(q.w_ff[c], p.w_ff.to(torch.int64))
            assert int(q.theta[c]) == int(p.theta_q)
        assert torch.equal(qs[0].w_rec[c], got[0].w_rec.to(torch.int64))
    # the recurrent matrix bounds the scale where its grid is the coarser one
    assert int(qs[0].w_rec[0].abs().max()) == 1 and int(qs[0].w_rec[2].abs().max()) > 1


def test_simulate_equals_run_int():
    config = _small_config()
    layers = config["network"]["layers"]
    weights = _weights(config)
    spikes, _ = _rasters()
    raster = torch.from_numpy(spikes.transpose(1, 0, 2).copy())
    res = reference_rec.simulate(layers, reference_rec.quantize(layers, weights, CANDS), raster)
    _, nets, qps = _program_qps(config, weights, CANDS)
    for c, (cand, qp) in enumerate(zip(nets, qps)):
        rec = run_int(cand, qp, raster)
        assert torch.equal(res.counts[c], rec.spike_counts.to(torch.int64))
        for l, per_step in enumerate(rec.layer_spikes):
            assert torch.equal(res.emitted[c, :, l], per_step.sum(dim=1).to(torch.int64))
        assert torch.equal(res.input_events, rec.input_events.sum(dim=1).to(torch.int64))
    assert int(res.emitted[:, :, 0].sum()) > 0, "the hidden layer never spiked"


def _gaps(config, weights, qps_of_program, truth, ds):
    net = program.network(config)
    nets = [program.candidate(net, c) for c in CANDS]
    accs, stats = eval_int_population(net, nets, qps_of_program, ds, batch_size=8, return_stats=True)
    return reference.gaps(accs, stats, truth)


def test_sweep_gaps_are_zero_and_the_control_and_a_dropped_recurrence_fail():
    config = _small_config()
    layers = config["network"]["layers"]
    weights = _weights(config)
    spikes, labels = _rasters()
    ds = SpikeDataset(spikes, labels, 4, "t")
    truth = reference_rec.evaluate(layers, reference_rec.quantize(layers, weights, CANDS), spikes,
                                   labels, "cpu", 8)
    _, _, qps = _program_qps(config, weights, CANDS)
    acc_gap, ev_gap = _gaps(config, weights, qps, truth, ds)
    assert acc_gap == 0 and ev_gap < 1e-3
    coarse = reference_rec.evaluate(layers, reference_rec.quantize(layers, weights, CANDS, 1),
                                    spikes, labels, "cpu", 8)
    assert reference.gaps(*reference.as_program_output(coarse), truth)[1] > 0.5
    dropped = [[qp[0]._replace(w_rec=torch.zeros_like(qp[0].w_rec))] + qp[1:] for qp in qps]
    assert _gaps(config, weights, dropped, truth, ds)[1] > 0.5


@pytest.mark.parametrize("name", ["snn-mnist-lif-ataf", "snn-mnist-lif-ff"])
def test_without_an_ata_t_layer_it_is_the_reference(name):
    config = run.load_json(run.HERE / "configs" / f"{name}.json")
    layers = config["network"]["layers"]
    weights = data.float_weights(5, layers, "cpu")
    cands = program.space(config)[::41]
    spikes, _ = data.heldout_rasters(5, 0, 6, 4, 0.35, "cpu")
    raster = torch.from_numpy(spikes.transpose(1, 0, 2).copy())
    for drop in (0, 1):
        got = reference_rec.quantize(layers, weights, cands, drop)
        want = reference.quantize(layers, weights, cands, drop)
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(vars(g).values(), vars(w).values()))
        a, b = reference_rec.simulate(layers, got, raster), reference.simulate(layers, want, raster)
        assert torch.equal(a.counts, b.counts) and torch.equal(a.emitted, b.emitted)


def test_reference_rec_imports_neither_the_port_nor_jax():
    tree = ast.parse((ROOT / "perfbench" / "reference_rec.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    assert names <= {"__future__", "numpy", "torch", "perfbench", "perfbench.reference"}


class _Kernels:
    """Keeps each kernel call's (name, bytes, operations)."""

    def __init__(self):
        self.calls = []

    def kernel_begin(self, name, flops, nbytes, operands=()):
        self.calls.append((name, nbytes, flops))


def _tiny_cell():
    """The ATA-T cell at ``tiny``'s size, over a space of 8 candidates that
    reach both routes of the recurrence (rec_bits 3 and 12), swept whole."""
    bench, cell, config, traffic = tiny(("snn-mnist-lif-atat", "sweep_rec_p512"))
    config["space"] = {"ff_bits": [4, 9], "rec_bits": [3, 12], "leak_bits": [2, 7]}
    traffic.update(population=8, check_sweeps=2)
    return bench, cell, config, traffic


def test_the_drivers_plan_and_operations_are_the_programs_calls():
    _, _, config, traffic = _tiny_cell()
    driver = sweep_rec.Driver(config, traffic, 2**31 + 21, "cpu")
    driver.warmup()
    sink = _Kernels()
    with program_work.listening(sink):
        units = driver.call()
    plan = driver.launches(0, 1)
    made = [(b, o) for name, b, o in sink.calls if name == "spike_matmul"]
    assert sorted(plan["spike_matmul_kernel"]) == sorted(made)
    assert len(made) == 2 + config["network"]["n_steps"]  # two layers, then T recurrence products
    assert driver.ops_per_unit() * units == sum(o for _, o in made)
    assert driver.weights[0][1].shape == (128, 128) and driver.qps[0][0].w_rec.shape == (128, 128)


def test_a_tiny_sweep_rec_cell_is_correct():
    bench, cell, config, traffic = _tiny_cell()
    result, _ = run.run_cell(bench, cell, 2**31 + 23, 0.2, False, "cpu", config, traffic)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 8
    assert result["checks"]["acc_gap"]["value"] == 0
