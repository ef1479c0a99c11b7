"""Streaming-session soak of the port: 500 seeded concurrent streams through
churn, as ``test_streaming_soak.py`` drives JAX's.

Marked ``slow`` as JAX's is (a nightly-length run; tier-1 deselects it via
the default ``-m "not slow"``), and run on the CPU and, where there is one,
the card.  A seeded RNG drives 500 sessions through random feed / idle /
close interleavings over a small lane pool, with idle sessions evicted to a
checkpoint store and restored on their next feed -- every poll reassigns
lanes across streams.

Invariants asserted at every poll round: lane conservation (``active_lanes
+ free_lanes == pool``) and session conservation (``live + evicted + closed
== opened``, in-flight bookkeeping consistent with state); at the end, a
sampled subset of sessions must have lifetime spike counts bit-identical to
a serial ``run_int`` over exactly the steps that session fed.

Where the oracle comes from: in the CPU case JAX's serial ``run_int`` on the
port's integers wherever the JAX package imports and there is no card; on
a machine with a card (where the JAX package is not run) and on one
without JAX, the port's serial ``run_int`` on the CPU, its
reference path, which ``tests/test_torch_backend.py`` holds to JAX bit for
bit.  JAX is imported only for that replay, so the file also runs on a
machine with a card and no JAX.
"""

import numpy as np
import pytest
import torch

from _serial_oracle import serial_oracle
from repro_torch.core.network import NetworkConfig, float_params_from_numpy, quantize_params
from repro_torch.core.snn_layer import LayerConfig, NeuronModel, ResetMode, Topology
from repro_torch.serve.snn_engine import SNNServeEngine
from repro_torch.serve.streaming import StreamConfig, StreamSessionManager

N_SESSIONS = 500
SEED = 20260808

NET = NetworkConfig(
    layers=(
        LayerConfig(n_in=16, n_out=10, neuron=NeuronModel.SYNAPTIC,
                    topology=Topology.ATA_T, reset=ResetMode.SUBTRACT, beta=0.9),
        LayerConfig(n_in=10, n_out=4, neuron=NeuronModel.LIF,
                    reset=ResetMode.ZERO, beta=0.77),
    ),
    n_steps=8,
)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _qparams():
    """Quantized weights from numpy-seeded uniform(+-1/sqrt(fan_in)) float
    weights (the recurrent [10, 10] matrix too), on the CPU."""
    rng = np.random.default_rng(0)
    arrays = []
    for c in NET.layers:
        w_ff = rng.uniform(-1, 1, (c.n_in, c.n_out)).astype(np.float32) / np.sqrt(c.n_in)
        if c.topology == Topology.ATA_T:
            w_rec = rng.uniform(-1, 1, (c.n_out, c.n_out)).astype(np.float32) / np.sqrt(c.n_out)
        else:
            w_rec = np.zeros(0, np.float32)
        arrays.append((w_ff, w_rec, np.float32(c.threshold)))
    return quantize_params(NET, float_params_from_numpy(NET, arrays, device="cpu"))[0]


def _stream_raster(sid: int, T: int) -> np.ndarray:
    """Each session's input stream is a pure function of its id: the serial
    cross-check can regenerate exactly what the session fed."""
    rng = np.random.default_rng(SEED + sid)
    return (rng.random((T, NET.n_in)) < 0.3).astype(np.int64)


def _check_conservation(mgr, engine, opened):
    assert engine.active_lanes + engine.free_lanes == engine.max_batch
    c = mgr.conservation()
    assert c["opened"] == opened
    assert c["live"] + c["evicted"] + c["closed"] == c["opened"]
    in_flight = [s for s in mgr.sessions.values() if s.in_flight]
    assert len(mgr._by_chunk) == len(in_flight)
    for s in mgr.sessions.values():
        if s.state != "live":
            assert not s.in_flight and not s.pending


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_streaming_soak_500_sessions(tmp_path, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    qparams = _qparams()
    engine = SNNServeEngine(NET, qparams, max_batch=8, tick_stride=8, device=device)
    mgr = StreamSessionManager(
        engine,
        checkpoint_dir=tmp_path / "ck",
        config=StreamConfig(window=10, stride=4, idle_budget=1, max_chunk_steps=32),
    )
    rng = np.random.default_rng(SEED)

    total_steps = {i: int(rng.integers(6, 28)) for i in range(N_SESSIONS)}
    fed = {i: 0 for i in range(N_SESSIONS)}
    opened_ids: list[int] = []
    closed_ids: set[int] = set()
    to_open = list(range(N_SESSIONS))

    # feed sparsely (well under the 8-lane service rate) so sessions spend
    # real time drained between chunks: with idle_budget=1 nearly every
    # inter-chunk gap evicts the carry to disk and the next feed restores it
    FEED_P, CLOSE_P = 0.012, 0.2
    while to_open or any(i not in closed_ids for i in opened_ids):
        for _ in range(min(len(to_open), int(rng.integers(1, 60)))):
            i = to_open.pop()
            mgr.open(f"s{i}")
            opened_ids.append(i)
        for i in opened_ids:
            if i in closed_ids:
                continue
            s = mgr.sessions[f"s{i}"]
            left = total_steps[i] - fed[i]
            act = rng.random()
            if left and act < FEED_P:
                n = int(min(left, rng.integers(1, 12)))
                mgr.feed(f"s{i}", _stream_raster(i, total_steps[i])[fed[i]:fed[i] + n])
                fed[i] += n
            elif not left and s.drained and act < CLOSE_P:
                mgr.close(f"s{i}")
                closed_ids.add(i)
        mgr.poll()
        _check_conservation(mgr, engine, len(opened_ids))

    mgr.pump()
    assert engine.free_lanes == engine.max_batch
    assert mgr.conservation() == {"opened": N_SESSIONS, "live": 0, "evicted": 0,
                                  "closed": N_SESSIONS}

    # churn actually happened (the invariants were tested under stress)
    snap = engine.metrics.snapshot()
    assert snap["streaming"]["evictions"] > 50
    assert snap["streaming"]["resumes"] > 50
    assert snap["counters"]["session_chunks"] >= N_SESSIONS

    oracle, serial = serial_oracle(device)
    for i in rng.choice(N_SESSIONS, size=25, replace=False):
        s = mgr.sessions[f"s{i}"]
        assert s.t_total == total_steps[i] == fed[i]
        raster = _stream_raster(i, total_steps[i])
        np.testing.assert_array_equal(
            s.counts_total, serial(NET, qparams, raster).astype(np.int64),
            err_msg=f"session s{i}: lifetime counts diverged from serial ({oracle})",
        )
        assert s.n_readouts == total_steps[i] // 4
