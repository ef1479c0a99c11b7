"""Backends, evaluation and the lane seams of the port against JAX ``reference``.

Every port backend and event strategy runs the same numpy rasters on the
same quantized weights as the JAX reference backend; records must be
identical.  Sizes stay small (widths <= 64, T <= 12) except one 256-128-10
case at batch 16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbe
from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.data import snn_datasets as jds
from repro.snn import train as jtrain
from repro_torch.core import backend as tbe
from repro_torch.core import network as tnet
from repro_torch.core import shard
from repro_torch.core import snn_layer as tsl
from repro_torch.data import snn_datasets as tds
from repro_torch.snn import train as ttrain

NEURONS = ["if", "lif", "synaptic"]
TOPOLOGIES = ["ff", "ata_f", "ata_t"]
RESETS = ["zero", "subtract"]


def _nets(n_in, hidden, n_out, T, neuron="lif", topology="ff", reset="subtract", **kw):
    def mk(sl, nw):
        l0 = sl.LayerConfig(n_in=n_in, n_out=hidden, neuron=sl.NeuronModel(neuron),
                            topology=sl.Topology(topology), reset=sl.ResetMode(reset),
                            beta=0.9, alpha=0.8, **kw)
        l1 = sl.LayerConfig(n_in=hidden, n_out=n_out, neuron=sl.NeuronModel(neuron),
                            reset=sl.ResetMode(reset), beta=0.77, **kw)
        return nw.NetworkConfig(layers=(l0, l1), n_steps=T)
    return mk(jsl, jnet), mk(tsl, tnet)


def _float_arrays(net, seed):
    """Float parameters from a numpy seed: uniform(+-1/sqrt(fan_in)) weights."""
    rng = np.random.default_rng(seed)
    arrays = []
    for cfg in net.layers:
        lim = 1 / np.sqrt(cfg.n_in)
        w_ff = rng.uniform(-lim, lim, (cfg.n_in, cfg.n_out)).astype(np.float32)
        if cfg.topology.value == "ata_t":
            w_rec = rng.uniform(-0.3, 0.3, (cfg.n_out, cfg.n_out)).astype(np.float32)
        elif cfg.topology.value == "ata_f":
            w_rec = np.float32(0.1)
        else:
            w_rec = np.zeros(0, np.float32)
        arrays.append((w_ff, w_rec, np.float32(cfg.threshold)))
    return arrays


def _qparams(jn, tn, seed=0):
    """Numpy-seeded weights quantized by the port (bit-equal to JAX's
    ``quantize_params``, held by test_torch_numerics.py), in both packages."""
    tq, _ = tnet.quantize_params(tn, tnet.float_params_from_numpy(tn, _float_arrays(tn, seed), "cpu"))
    jq = [jsl.IntLayerParams(*(jnp.asarray(a.numpy()) for a in p)) for p in tq]
    return jq, tq


def _raster(T, B, n_in, rate, seed=1, max_val=1):
    rng = np.random.default_rng(seed)
    on = rng.random((T, B, n_in)) < rate
    return np.where(on, rng.integers(1, max_val + 1, (T, B, n_in)), 0).astype(np.int32)


def _assert_record(trec, jrec):
    np.testing.assert_array_equal(trec.spike_counts.cpu().numpy(), np.asarray(jrec.spike_counts))
    assert trec.spike_counts.dtype == torch.int32
    assert len(trec.layer_spikes) == len(jrec.layer_spikes)
    for a, b in zip(trec.layer_spikes, jrec.layer_spikes):
        np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b))
    np.testing.assert_array_equal(trec.input_events.cpu().numpy(), np.asarray(jrec.input_events))


PORT_BACKENDS = {
    "reference": lambda: "reference",
    "fused": lambda: "fused",
    "event-auto": lambda: "event",
    "event-gather": lambda: tbe.EventBackend(strategy="gather"),
    "event-csr": lambda: tbe.EventBackend(strategy="csr"),
    "event-pallas": lambda: tbe.EventBackend(strategy="pallas"),
    "event-pallas-kernel-route": lambda: tbe.EventBackend(strategy="pallas", use_pallas=True),
}


def _check_all_backends(jn, tn, x, seed=0):
    jq, tq = _qparams(jn, tn, seed)
    want = jnet.run_int(jn, jq, jnp.asarray(x), backend="reference")
    for name, make in PORT_BACKENDS.items():
        got = tnet.run_int(tn, tq, torch.from_numpy(x), backend=make())
        try:
            _assert_record(got, want)
        except AssertionError as e:
            raise AssertionError(f"port backend {name} differs from JAX reference") from e
    return want


@pytest.mark.parametrize("reset", RESETS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("neuron", NEURONS)
def test_every_backend_matches_jax_reference(neuron, topology, reset):
    jn, tn = _nets(48, 32, 10, 8, neuron, topology, reset)
    _check_all_backends(jn, tn, _raster(8, 4, 48, 0.1, seed=len(neuron + topology)))


@pytest.mark.parametrize("rate", [0.02, 0.3], ids=["sparse2", "mid30"])
@pytest.mark.parametrize(
    "neuron,topology,reset",
    [("lif", "ff", "zero"), ("if", "ff", "subtract"), ("synaptic", "ata_t", "subtract")],
)
def test_backends_across_densities(neuron, topology, reset, rate):
    jn, tn = _nets(64, 24, 10, 10, neuron, topology, reset)
    _check_all_backends(jn, tn, _raster(10, 3, 64, rate, seed=int(rate * 100)))


def test_dense_fallback_and_graded_input():
    """Graded values up to 9 at 60% density: every event strategy takes the
    density fallback, the pallas strategy at both f32 certificate outcomes."""
    jn, tn = _nets(40, 16, 10, 6, w_bits=12)
    x = _raster(6, 3, 40, 0.6, seed=4, max_val=9)
    _check_all_backends(jn, tn, x)
    jq, tq = _qparams(jn, tn)
    want = jnet.run_int(jn, jq, jnp.asarray(x), backend="reference")
    for thr in (0.05, 1.0):
        backend = tbe.EventBackend(strategy="pallas", dense_threshold=thr)
        _assert_record(tnet.run_int(tn, tq, torch.from_numpy(x), backend=backend), want)


def test_zero_input_window():
    jn, tn = _nets(32, 16, 10, 5)
    want = _check_all_backends(jn, tn, np.zeros((5, 2, 32), np.int32))
    assert int(np.asarray(want.spike_counts).sum()) == 0


def test_paper_width_network_at_batch_16():
    """The 256-128-10 LIF design point (w6/u16) through every backend."""
    layers = lambda sl: (sl.LayerConfig(n_in=256, n_out=128), sl.LayerConfig(n_in=128, n_out=10))
    jn = jnet.NetworkConfig(layers=layers(jsl), n_steps=12)
    tn = tnet.NetworkConfig(layers=layers(tsl), n_steps=12)
    ds = jds.mnist_like(n=16, T=12, seed=3)
    x = np.ascontiguousarray(ds.spikes.transpose(1, 0, 2)).astype(np.int32)
    want = _check_all_backends(jn, tn, x)
    assert int(np.asarray(want.layer_spikes[0]).sum()) > 0


def _dataset(pkg, n=40, T=6, C=48, seed=11):
    rng = np.random.default_rng(seed)
    spikes = (rng.random((n, T, C)) < 0.12).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int32)
    return pkg.SpikeDataset(spikes, labels, 10, "rand")


@pytest.mark.parametrize("backend", ["reference", "fused", "event"])
def test_eval_int_accuracy_and_stats_equal(backend):
    jn, tn = _nets(48, 32, 10, 6)
    jq, tq = _qparams(jn, tn, seed=2)
    jacc, jstats = jtrain.eval_int(jn, jq, _dataset(jds), batch_size=16, return_stats=True)
    tacc, tstats = ttrain.eval_int(
        tn, tq, _dataset(tds), batch_size=16, return_stats=True, backend=backend
    )
    assert tacc == jacc
    np.testing.assert_array_equal(tstats["input_events_per_step"], jstats["input_events_per_step"])
    for a, b in zip(tstats["layer_events_per_step"], jstats["layer_events_per_step"]):
        np.testing.assert_array_equal(a, b)
    assert ttrain.eval_int(tn, tq, _dataset(tds), batch_size=16, backend=backend) == jacc


@pytest.mark.parametrize("topology,neuron", [("ff", "lif"), ("ata_t", "synaptic")])
def test_run_int_batched_ragged_matches_jax_and_serial(topology, neuron):
    jn, tn = _nets(32, 16, 10, 9, neuron, topology)
    jq, tq = _qparams(jn, tn)
    x = _raster(9, 5, 32, 0.2, seed=6)
    lengths = np.array([9, 3, 7, 1, 5], np.int32)
    for b, L in enumerate(lengths):
        x[L:, b] = 0
    want = jbe.run_int_batched(jn, jq, x, lengths)
    got = tbe.run_int_batched(tn, tq, x, lengths)
    _assert_record(got, want)
    for b, L in enumerate(lengths):
        serial = tnet.run_int(tn, tq, torch.from_numpy(x[:L, b : b + 1]))
        assert torch.equal(got.spike_counts[b], serial.spike_counts[0])
    full = tbe.run_int_batched(tn, tq, x)
    _assert_record(full, jbe.run_int_batched(jn, jq, x))
    # mesh= shards the sample axis: 4 shards on the CPU give the same record
    mesh = shard.make_mesh(4, devices=["cpu"] * 4)
    _assert_record(tbe.run_int_batched(tn, tq, x, lengths, mesh=mesh), want)


@pytest.mark.parametrize(
    "ff_mode,budget", [("int32", None), ("f32_exact", None), ("f32_exact", 16)]
)
def test_batched_lane_window_chunks_match_jax(ff_mode, budget):
    """Two chunks with fresh lanes, mid-chunk completion (valid_steps) and a
    reset between them: pool state, outputs and emitted counts identical."""
    jn, tn = _nets(32, 16, 10, 8, "lif", "ata_t")
    jq, tq = _qparams(jn, tn)
    lanes = 4
    jst = jbe.batched_lane_init(jn, lanes)
    tst = tbe.batched_lane_init(tn, lanes, device="cpu")
    chunks = [
        (_raster(4, lanes, 32, 0.1, seed=8), [1, 1, 1, 0], [4, 2, 4, 0]),
        (_raster(4, lanes, 32, 0.1, seed=9), [0, 1, 0, 1], [3, 4, 1, 4]),
    ]
    for x, reset, valid in chunks:
        reset, valid = np.array(reset, bool), np.array(valid, np.int32)
        jst, jout, jem = jbe.batched_lane_window(
            jn, jq, jst, jnp.asarray(x), jnp.asarray(reset), jnp.asarray(valid),
            ff_mode=ff_mode, event_budget=budget,
        )
        tst2, tout, tem = tbe.batched_lane_window(
            tn, tq, tst, torch.from_numpy(x), torch.from_numpy(reset), torch.from_numpy(valid),
            ff_mode=ff_mode, event_budget=budget,
        )
        assert tst2 is tst  # the pool is updated in place
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
        for a, b in zip(tst, jst):
            for fa, fb in zip(a, b):
                np.testing.assert_array_equal(fa.numpy(), np.asarray(fb))


def test_lane_tick_and_state_take_put():
    jn, tn = _nets(32, 16, 10, 4)
    jq, tq = _qparams(jn, tn)
    x = _raster(1, 3, 32, 0.3, seed=2)[0]
    reset = np.array([True, True, True])
    jst, jout, jem = jbe.batched_lane_tick(
        jn, jq, jbe.batched_lane_init(jn, 3), jnp.asarray(x), jnp.asarray(reset)
    )
    tst, tout, tem = tbe.batched_lane_tick(
        tn, tq, tbe.batched_lane_init(tn, 3, device="cpu"), torch.from_numpy(x),
        torch.from_numpy(reset),
    )
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    snap = tbe.lane_state_take(tst, 1)
    jsnap = jbe.lane_state_take(jst, 1)
    for a, b in zip(snap, jsnap):
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa, fb)
    fresh = tbe.batched_lane_init(tn, 3, device="cpu")
    tbe.lane_state_put(fresh, 2, snap)
    for a, b in zip(fresh, tst):
        for fa, fb in zip(a, b):
            assert torch.equal(fa[2], fb[1]) and not fa[0].any()


def test_registry_and_backend_identity():
    assert tbe.available_backends() == ["event", "fused", "reference"]
    assert tbe.get_backend("reference") == tbe.ReferenceBackend()
    assert hash(tbe.ReferenceBackend()) == hash(tbe.ReferenceBackend())
    assert tbe.EventBackend(strategy="pallas") == tbe.EventBackend(strategy="pallas")
    assert tbe.EventBackend(strategy="pallas") != tbe.EventBackend(strategy="gather")
    with pytest.raises(ValueError, match="unknown inference backend"):
        tbe.get_backend("nope")
    with pytest.raises(ValueError, match="unknown event strategy"):
        tbe.EventBackend(strategy="nope")
    ev = tbe.EventBackend()
    assert ev.resolved_strategy("cuda") == "gather" and ev.resolved_strategy("cpu") == "csr"
    assert tbe.EventBackend(strategy="csr").jit_surrogate(None, torch.zeros(1)) is None
    twin = ev.jit_surrogate(None, torch.from_numpy(_raster(3, 2, 32, 0.2, max_val=3)))
    jtwin = jbe.EventBackend().jit_surrogate(None, jnp.asarray(_raster(3, 2, 32, 0.2, max_val=3)))
    assert (twin.strategy, twin.event_budget, twin.input_max_val) == (
        jtwin.strategy, jtwin.event_budget, jtwin.input_max_val,
    )
    for n_in, thr in [(256, 0.1), (64, 0.03), (16, 0.5)]:
        assert ev.serve_budget(n_in, thr) == jbe.EventBackend().serve_budget(n_in, thr)
        assert ev.static_budget(n_in, 5) == jbe.EventBackend().static_budget(n_in, 5)


def test_record_event_stats_match_jax():
    jn, tn = _nets(32, 16, 10, 7)
    jq, tq = _qparams(jn, tn)
    x = _raster(7, 6, 32, 0.25, seed=3)
    jrec = jnet.run_int(jn, jq, jnp.asarray(x))
    trec = tnet.run_int(tn, tq, torch.from_numpy(x))
    js, ts = jrec.event_stats(), trec.event_stats()
    np.testing.assert_array_equal(ts["input_events_per_step"], js["input_events_per_step"])
    for a, b in zip(ts["layer_events_per_step"], js["layer_events_per_step"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trec.predictions().numpy(), np.asarray(jrec.predictions()))
