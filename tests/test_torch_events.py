"""The port's AER packet codec and strict event-driven core.

``tests/test_snn_core.py``'s packet and ``EventDrivenCore`` cases and
``tests/test_snn_core_props.py``'s property (the vectorised
``int_layer_step`` == the per-event scalar model whenever no intermediate
accumulation saturates) re-pointed at ``repro_torch.core.events`` and the
port's ``int_layer_step`` on the CPU; beside them, the port's and JAX's
``EventDrivenCore`` fire the same spikes, end in the same state and count
the same cycles on the same inputs.
"""

import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core import snn_layer as jsl
from repro_torch.core import snn_layer as tsl
from repro_torch.core.events import (
    EventDrivenCore,
    PacketKind,
    decode_packet,
    encode_packet,
    raster_to_packets,
)


def test_packet_roundtrip():
    for kind, addr in [(PacketKind.ASPL, 7), (PacketKind.ASCL, 255), (PacketKind.EOTS, 0),
                       (PacketKind.EOIN, 0)]:
        got_kind, payload = decode_packet(encode_packet(kind, addr),
                                          recurrent_path=(kind == PacketKind.ASCL))
        assert got_kind == kind
        if kind in (PacketKind.ASPL, PacketKind.ASCL):
            assert payload == addr


def test_raster_to_packets_ends_with_eoin():
    steps = raster_to_packets(np.asarray([[1, 0, 1], [0, 0, 0]]))
    assert decode_packet(steps[0][-1])[0] == PacketKind.EOTS
    assert decode_packet(steps[1][-1])[0] == PacketKind.EOIN
    assert len(steps[0]) == 3  # two ASPL + EOTS


def test_packet_words_pinned():
    """The exact wire encodings the events.py docstring documents."""
    assert encode_packet(PacketKind.ASPL, 0) == 0x000
    assert encode_packet(PacketKind.ASPL, 0xAB) == 0x0AB
    assert encode_packet(PacketKind.ASCL, 0xAB) == 0x0AB
    assert encode_packet(PacketKind.EOTS) == 0x100
    assert encode_packet(PacketKind.EOIN) == 0x101
    assert decode_packet(0x100) == (PacketKind.EOTS, 0)
    assert decode_packet(0x101) == (PacketKind.EOIN, 1)
    assert decode_packet(0x0AB) == (PacketKind.ASPL, 0xAB)
    assert decode_packet(0x0AB, recurrent_path=True) == (PacketKind.ASCL, 0xAB)
    for bad in (-1, 256):
        with pytest.raises(ValueError):
            encode_packet(PacketKind.ASPL, bad)


def test_eoin_lazy_reset_zeroes_state_after_spike_generation():
    """The final step still integrates, leaks and fires normally, then the
    sweep writes zeros instead of the computed next state."""
    cfg = tsl.LayerConfig(n_in=2, n_out=2, neuron=tsl.NeuronModel.SYNAPTIC, beta=0.9, alpha=0.9)
    core = EventDrivenCore(cfg, w_ff=np.asarray([[60, 1], [1, 1]]), w_rec=np.zeros((0,)),
                           theta_q=50)
    assert core.step([0], last=True) == [0]  # integration + spike generation happened
    assert (core.u == 0).all() and (core.i_syn == 0).all()  # lazy reset
    assert core.step([0], last=True) == [0]  # a fresh sample sees virgin state


def _case(rng, neuron, topology, reset, sl):
    cfg = sl.LayerConfig(
        n_in=int(rng.integers(2, 13)), n_out=int(rng.integers(2, 11)),
        neuron=sl.NeuronModel(neuron), topology=sl.Topology(topology),
        reset=sl.ResetMode(reset), w_bits=int(rng.integers(3, 9)), u_bits=16, i_bits=16,
        leak_bits=int(rng.integers(2, 9)), beta=float(rng.uniform(0.3, 0.99)),
        alpha=float(rng.uniform(0.3, 0.99)), threshold=1.0,
    )
    return cfg


def _weights(rng, cfg):
    w_ff = rng.integers(-20, 21, (cfg.n_in, cfg.n_out))
    if cfg.topology.value == "ata_t":
        w_rec = rng.integers(-10, 11, (cfg.n_out, cfg.n_out))
    elif cfg.topology.value == "ata_f":
        w_rec = np.asarray(rng.integers(-10, 11))
    else:
        w_rec = np.zeros((0,), np.int64)
    return w_ff, w_rec


def _event_driven(core_cls, cfg, w_ff, w_rec, raster):
    core = core_cls(cfg, w_ff, w_rec, 40)
    spikes = np.zeros((raster.shape[0], cfg.n_out), np.int64)
    for t in range(raster.shape[0]):
        spikes[t, core.step(list(np.nonzero(raster[t])[0]), last=t == raster.shape[0] - 1)] = 1
    return core, spikes


def _vectorised(cfg, w_ff, w_rec, raster):
    params = tsl.IntLayerParams(
        w_ff=torch.as_tensor(w_ff, dtype=torch.int32),
        w_rec=torch.as_tensor(w_rec, dtype=torch.int32),
        theta_q=torch.tensor(40, dtype=torch.int32),
    )
    state = tsl.int_layer_init(cfg, 1, device="cpu")
    got = np.zeros((raster.shape[0], cfg.n_out), np.int64)
    for t in range(raster.shape[0]):
        state, spk = tsl.int_layer_step(cfg, params, state, torch.as_tensor(raster[None, t]))
        got[t] = spk[0].numpy()
    return got


@pytest.mark.parametrize("neuron", ["if", "lif", "synaptic"])
@pytest.mark.parametrize("topology", ["ff", "ata_f", "ata_t"])
def test_event_driven_core_equals_jax_core(neuron, topology):
    """Same config, weights and raster: the port's and JAX's strict cores
    fire the same spikes, end in the same state, count the same cycles."""
    rng = np.random.default_rng([ord(c) for c in neuron + "/" + topology])
    for reset in ("zero", "subtract"):
        cfg_t = _case(np.random.default_rng(rng.integers(2**32)), neuron, topology, reset, tsl)
        cfg_j = jsl.LayerConfig(**{f: getattr(cfg_t, f) for f in cfg_t.__dataclass_fields__})
        w_ff, w_rec = _weights(rng, cfg_t)
        raster = (rng.random((7, cfg_t.n_in)) < 0.3).astype(np.int64)
        mine, got = _event_driven(EventDrivenCore, cfg_t, w_ff, w_rec, raster)
        theirs, want = _event_driven(jev.EventDrivenCore, cfg_j, w_ff, w_rec, raster)
        np.testing.assert_array_equal(got, want)
        for f in ("u", "i_syn", "prev_spk"):
            np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))
        assert mine.cycle_count == theirs.cycle_count > 0


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # hypothesis is a CI-only dependency (requirements-dev)
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @st.composite
    def _layer_case(draw):
        cfg = tsl.LayerConfig(
            n_in=draw(st.integers(2, 12)),
            n_out=draw(st.integers(2, 10)),
            neuron=draw(st.sampled_from(list(tsl.NeuronModel))),
            topology=draw(st.sampled_from(list(tsl.Topology))),
            reset=draw(st.sampled_from([tsl.ResetMode.ZERO, tsl.ResetMode.SUBTRACT])),
            w_bits=draw(st.integers(3, 8)),
            u_bits=16,
            i_bits=16,
            leak_bits=draw(st.integers(2, 8)),
            beta=draw(st.floats(0.3, 0.99)),
            alpha=draw(st.floats(0.3, 0.99)),
            threshold=1.0,
        )
        return cfg, draw(st.integers(2, 8)), draw(st.integers(0, 2**31 - 1))

    @given(_layer_case())
    @settings(max_examples=40, deadline=None)
    def test_vectorised_matches_event_driven_reference(case):
        """The port's int_layer_step == its EventDrivenCore (per-event RTL model)."""
        cfg, T, seed = case
        rng = np.random.default_rng(seed)
        w_ff, w_rec = _weights(rng, cfg)
        raster = (rng.random((T, cfg.n_in)) < 0.3).astype(np.int64)
        _, ref_spikes = _event_driven(EventDrivenCore, cfg, w_ff, w_rec, raster)
        np.testing.assert_array_equal(_vectorised(cfg, w_ff, w_rec, raster), ref_spikes)

else:  # pragma: no cover - visible skip in environments without hypothesis

    @pytest.mark.skip(reason="hypothesis not installed (CI-only dependency)")
    def test_vectorised_matches_event_driven_reference():
        pass
