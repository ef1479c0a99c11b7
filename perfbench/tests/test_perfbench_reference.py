"""The plain reference against the port, at small sizes on the CPU.

The reference re-derives every quantized weight, threshold and decay register
from the float weights and steps the layers in int64; through the port's plain
CPU paths (``quantize_params``, ``run_int``, ``eval_int_population``,
``eval_int`` on the event backend) the two agree exactly, and the control (one
bit coarser) fails both limits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from _perfbench_tiny import run, tiny

from perfbench import data, program, reference
from repro_torch.core.backend import EventBackend
from repro_torch.core.network import quantize_params, run_int
from repro_torch.core.snn_layer import LayerConfig
from repro_torch.data.snn_datasets import SpikeDataset
from repro_torch.snn.train import eval_int, eval_int_population

CONFIGS = ["snn-mnist-lif-ataf", "snn-mnist-lif-ff"]


def _config(name, T=5):
    config = run.load_json(run.HERE / "configs" / f"{name}.json")
    config["network"]["n_steps"] = T
    return config


@pytest.mark.parametrize("beta", [0.95, 0.7, 0.5, 0.999, 0.0])
def test_decay_register_is_the_coefficient_generators(beta):
    for leak_bits in range(1, 9):
        cfg = LayerConfig(n_in=4, n_out=4, beta=beta, leak_bits=leak_bits)
        assert reference.decay_register(beta, leak_bits) == cfg.beta_code().decay_rate_register


@pytest.mark.parametrize("name", CONFIGS)
def test_quantize_equals_the_ports_quantize_params(name):
    config = _config(name)
    layers = config["network"]["layers"]
    weights = data.float_weights(11, layers, "cpu")
    net = program.network(config)
    space = program.space(config)[::7]
    qs = reference.quantize(layers, weights, space)
    for c, cfg in enumerate(space):
        got = quantize_params(program.candidate(net, cfg), program.float_params(weights))[0]
        for q, p in zip(qs, got):
            assert torch.equal(q.w_ff[c], p.w_ff.to(torch.int64))
            assert int(q.theta[c]) == int(p.theta_q)
            if p.w_rec.numel():
                assert int(q.w_rec[c]) == int(p.w_rec)


@pytest.mark.parametrize("name", CONFIGS)
def test_simulate_equals_run_int(name):
    config = _config(name)
    layers = config["network"]["layers"]
    weights = data.float_weights(5, layers, "cpu")
    spikes, labels = data.heldout_rasters(5, 0, 12, 5, 0.35, "cpu")
    net = program.network(config)
    space = program.space(config)[::37]
    qs = reference.quantize(layers, weights, space)
    raster = torch.from_numpy(spikes.transpose(1, 0, 2).copy())
    res = reference.simulate(layers, qs, raster)
    for c, cfg in enumerate(space):
        cand = program.candidate(net, cfg)
        rec = run_int(cand, quantize_params(cand, program.float_params(weights))[0], raster)
        assert torch.equal(res.counts[c], rec.spike_counts.to(torch.int64))
        for l, per_step in enumerate(rec.layer_spikes):
            assert torch.equal(res.emitted[c, :, l], per_step.sum(dim=1).to(torch.int64))
        assert torch.equal(res.input_events, rec.input_events.sum(dim=1).to(torch.int64))
    assert int(res.emitted[:, :, 0].sum()) > 0, "the hidden layer never spiked"


@pytest.mark.parametrize("name", CONFIGS)
def test_sweep_gaps_are_zero_and_the_control_fails(name):
    config = _config(name)
    layers = config["network"]["layers"]
    weights = data.float_weights(3, layers, "cpu")
    spikes, labels = data.heldout_rasters(3, 0, 16, 5, 0.35, "cpu")
    ds = SpikeDataset(spikes, labels, 10, "t")
    net = program.network(config)
    space = program.space(config)[::11]
    cands = [program.candidate(net, c) for c in space]
    qps = [quantize_params(c, program.float_params(weights))[0] for c in cands]
    accs, stats = eval_int_population(net, cands, qps, ds, batch_size=16, return_stats=True)
    truth = reference.evaluate(layers, reference.quantize(layers, weights, space), spikes,
                               labels, "cpu", 16)
    acc_gap, ev_gap = reference.gaps(accs, stats, truth)
    assert acc_gap == 0 and ev_gap < 1e-3
    coarse = reference.evaluate(layers, reference.quantize(layers, weights, space, 1), spikes,
                                labels, "cpu", 16)
    c_acc, c_ev = reference.gaps(*reference.as_program_output(coarse), truth)
    assert c_ev > 0.5


def test_event_backend_gaps_are_zero():
    config = _config("snn-mnist-lif-ff", T=6)
    layers = config["network"]["layers"]
    weights = data.float_weights(9, layers, "cpu")
    spikes, labels = data.heldout_rasters(9, 1, 20, 6, 0.35, "cpu")
    ds = SpikeDataset(spikes, labels, 10, "t")
    net = program.network(config)
    qp = quantize_params(net, program.float_params(weights))[0]
    backend = EventBackend(strategy="pallas")
    acc, stats = eval_int(net, qp, ds, batch_size=8, return_stats=True, backend=backend)
    cfg = layers[0]
    qs = reference.quantize(layers, weights, [(cfg["w_bits"], cfg["w_rec_bits"], cfg["leak_bits"])])
    truth = reference.evaluate(layers, qs, spikes, labels, "cpu", 8)
    assert reference.gaps(np.array([acc]), [stats], truth) == (0, pytest.approx(0, abs=1e-3))


def test_heldout_rasters_keep_the_class_numbers_and_the_seed():
    a, la = data.heldout_rasters(2**31 + 99, 0, 23, 3, 0.35, "cpu")
    b, lb = data.heldout_rasters(2**31 + 99, 0, 23, 3, 0.35, "cpu")
    c, lc = data.heldout_rasters(2**31 + 98, 0, 23, 3, 0.35, "cpu")
    assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert not np.array_equal(a, c)
    assert np.bincount(la, minlength=10).tolist() == np.bincount(lc, minlength=10).tolist()
    assert a.dtype == np.uint8 and a.shape == (23, 3, 256) and set(np.unique(a)) <= {0, 1}


def test_tiny_cells_are_correct_against_the_reference():
    for pair in (("snn-mnist-lif-ataf", "sweep_p512"), ("snn-mnist-lif-ff", "infer_10k")):
        bench, cell, config, traffic = tiny(pair)
        result, _ = run.run_cell(bench, cell, 12345, 0.2, False, "cpu", config, traffic)
        assert result["correct"] and result["failed"] == 0
