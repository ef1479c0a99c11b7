"""The port's event backend under ``test_event_backend_props.py``'s sweep.

Random networks across neuron models x topologies x reset modes x bit widths
x input densities (silent and near-dense rasters included), drawn by JAX's
strategy; parameters and rasters from ``jax.random``, carried through
numpy.  The port's ``run_int(backend="event")`` must give JAX's
``reference`` records -- spike counts, every layer's spikes, the input
events -- integer for integer.
Self-skips without hypothesis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property suite needs hypothesis (pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

import torch

from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro_torch.core import network as tnet
from repro_torch.core import snn_layer as tsl
from repro_torch.core.backend import EventBackend

NEURONS = ["if", "lif", "synaptic"]
TOPOS = ["ff", "ata_f", "ata_t"]


@st.composite
def network_case(draw):
    n_in = draw(st.integers(3, 40))
    hidden = draw(st.integers(2, 24))
    n_out = draw(st.integers(2, 10))
    neuron = draw(st.sampled_from(NEURONS))
    topology = draw(st.sampled_from(TOPOS))
    reset = draw(st.sampled_from(["zero", "subtract"]))
    layers = (
        dict(n_in=n_in, n_out=hidden, neuron=neuron, topology=topology, reset=reset,
             w_bits=draw(st.integers(3, 8)), leak_bits=draw(st.integers(2, 8)),
             beta=draw(st.floats(0.3, 0.99)), alpha=draw(st.floats(0.3, 0.99))),
        dict(n_in=hidden, n_out=n_out, neuron=neuron, reset=reset,
             beta=draw(st.floats(0.3, 0.99)), alpha=draw(st.floats(0.3, 0.99))),
    )
    n_steps = draw(st.integers(2, 8))
    rate = draw(st.sampled_from([0.0, 0.03, 0.1, 0.3, 0.7, 1.0]))
    batch = draw(st.integers(1, 5))
    seed = draw(st.integers(0, 2**31 - 1))
    threshold = draw(st.sampled_from([0.2, 0.5, 1.0]))
    return (layers, n_steps), rate, batch, seed, threshold


def _net(sl, nw, spec):
    layers, n_steps = spec

    def layer(d):
        d = dict(d)
        d["neuron"] = sl.NeuronModel(d["neuron"])
        d["reset"] = sl.ResetMode(d["reset"])
        if "topology" in d:
            d["topology"] = sl.Topology(d["topology"])
        return sl.LayerConfig(**d)

    return nw.NetworkConfig(layers=tuple(layer(d) for d in layers), n_steps=n_steps)


# one compiled draw for every case: the largest raster the strategy asks for,
# sliced to each case's shape (a draw per shape would compile per example)
_UNIFORM = jax.jit(lambda key: jax.random.uniform(jax.random.fold_in(key, 1), (8, 5, 40)))


def _both(case):
    """JAX's reference record and the port's net, qparams and raster.  The
    port quantizes (bit-equal to JAX's ``quantize_params``,
    ``tests/test_torch_numerics.py``) and JAX runs on those integers."""
    spec, rate, batch, seed, _ = case
    jn, tn = _net(jsl, jnet, spec), _net(tsl, tnet, spec)
    key = jax.random.PRNGKey(seed)
    arrays = [tuple(np.asarray(x) for x in p) for p in jnet.init_float_params(key, jn)]
    tq, _ = tnet.quantize_params(tn, tnet.float_params_from_numpy(tn, arrays, device="cpu"))
    jq = [jsl.IntLayerParams(*(jnp.asarray(t.numpy()) for t in p)) for p in tq]
    u = np.asarray(_UNIFORM(key))[: jn.n_steps, :batch, : jn.n_in]
    spikes = (u < rate).astype(np.int32)
    ref = jnet.run_int(jn, jq, jnp.asarray(spikes))
    return ref, tn, tq, torch.from_numpy(spikes)


def _assert_record(got, ref):
    np.testing.assert_array_equal(got.spike_counts.numpy(), np.asarray(ref.spike_counts))
    assert len(got.layer_spikes) == len(ref.layer_spikes)
    for a, b in zip(got.layer_spikes, ref.layer_spikes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.input_events.numpy(), np.asarray(ref.input_events))


@given(network_case())
@settings(max_examples=40, deadline=None)
def test_event_backend_matches_reference(case):
    """The port's run_int(backend="event") is JAX's reference, bit for bit."""
    ref, tn, tq, spikes = _both(case)
    _assert_record(tnet.run_int(tn, tq, spikes, backend="event"), ref)


@given(network_case(), st.floats(0.05, 1.0))
@settings(max_examples=15, deadline=None)
def test_event_backend_threshold_invariant(case, dense_threshold):
    """The dense/sparse routing knob is a speed knob, never a numerics knob."""
    ref, tn, tq, spikes = _both(case)
    got = tnet.run_int(tn, tq, spikes, backend=EventBackend(dense_threshold=dense_threshold))
    _assert_record(got, ref)
