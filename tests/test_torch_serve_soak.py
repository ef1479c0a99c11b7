"""Deterministic soak of the port's engine: 10k randomized requests through
the full scheduler, as ``test_serve_soak.py`` drives JAX's.

Marked ``slow`` as JAX's is (a nightly-length run; tier-1 deselects it via
the default ``-m "not slow"``), and run on the CPU and, where there is one,
the card.  Seeded RNG, so the workload mix -- priorities, tenants, ragged
windows, densities, deadlines -- is identical every run; only
wall-clock-dependent verdicts (degrade vs reject under the live service
estimate) may vary, and every assertion is robust to that split.

At every poll the lane accounting must hold: ``active_lanes + free_lanes ==
pool``, no request on two lanes, no finished request still occupying one.
At the end the engine must be fully drained with every request at exactly
one terminal state, and a sampled subset must be bit-exact with a serial
``run_int`` (full precision or the degraded tier's).

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
from repro_torch.serve.scheduler import PrecisionTier, Priority, SchedPolicy
from repro_torch.serve.snn_engine import SNNRequest, SNNServeEngine

N_REQUESTS = 10_000
SEED = 20260808

NET = NetworkConfig(
    layers=(
        LayerConfig(n_in=16, n_out=10, neuron=NeuronModel.LIF, topology=Topology.FF,
                    reset=ResetMode.SUBTRACT, beta=0.9),
        LayerConfig(n_in=10, n_out=4, neuron=NeuronModel.LIF,
                    reset=ResetMode.ZERO, beta=0.77),
    ),
    n_steps=12,
)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _params():
    """uniform(+-1/sqrt(fan_in)) float weights from a numpy seed, on the CPU."""
    rng = np.random.default_rng(0)
    arrays = [
        (rng.uniform(-1, 1, (c.n_in, c.n_out)).astype(np.float32) / np.sqrt(c.n_in),
         np.zeros(0, np.float32), np.float32(c.threshold))
        for c in NET.layers
    ]
    return float_params_from_numpy(NET, arrays, device="cpu")


def _check_lane_accounting(eng):
    assert eng.active_lanes + eng.free_lanes == eng.max_batch
    occupied = [lane for lane in eng._lanes if lane is not None]
    uids = [lane.req.uid for lane in occupied]
    assert len(uids) == len(set(uids))  # no request on two lanes
    for lane in occupied:
        assert not lane.req.finished  # finished requests free immediately
        assert lane.req._suspended is None  # suspended implies off-lane


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_soak_10k_requests_conserves_lanes_and_requests(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = _params()
    qparams, _ = quantize_params(NET, params)
    tier = PrecisionTier.from_params(NET, params, w_bits=3, steps_fraction=0.5)
    eng = SNNServeEngine(
        NET, qparams, max_batch=8, tick_stride=8,
        scheduler=SchedPolicy(preempt_min_remaining_steps=2),
        precision_tiers=[tier], device=device,
    )
    eng.warmup()
    eng.metrics.seed_step_estimate(1e-4)

    rng = np.random.default_rng(SEED)
    terminal: dict[int, int] = {}

    def note(req):
        terminal[req.uid] = terminal.get(req.uid, 0) + 1

    reqs = []
    for uid in range(N_REQUESTS):
        T = int(rng.integers(1, 13))
        rate = float(rng.choice([0.05, 0.2, 0.5]))
        deadline = [None, None, None, 1e9, 0.02, 1e-9][int(rng.integers(0, 6))]
        reqs.append(
            SNNRequest(
                uid=uid,
                raster=(rng.random((T, NET.n_in)) < rate).astype(np.int32),
                priority=Priority(int(rng.integers(0, 3))),
                tenant=["a", "b", "c"][uid % 3],
                deadline_s=deadline,
                on_complete=note,
            )
        )

    # submit in bursts interleaved with polls, so admission constantly races
    # completion (the continuous-batching steady state, not one big drain)
    done = []
    i = 0
    while i < len(reqs) or eng.in_flight:
        burst = int(rng.integers(0, 48))
        for r in reqs[i : i + burst]:
            eng.submit(r)
        i += burst
        done.extend(eng.poll())
        _check_lane_accounting(eng)

    assert not eng.in_flight and eng.free_lanes == eng.max_batch
    assert len(done) == N_REQUESTS
    assert sorted(r.uid for r in done) == list(range(N_REQUESTS))
    assert all(terminal.get(u) == 1 for u in range(N_REQUESTS))
    c = eng.metrics.counters
    assert c["submitted"] == N_REQUESTS
    assert c["completed"] + c["degraded"] + c["rejected"] == N_REQUESTS
    assert c["rejected"] + c["degraded"] > 0  # the 1e-9/0.02 deadlines acted
    assert c["preempted"] == c["resumed"]

    # deterministic preemption coda: fill the pool with long best-effort
    # windows, then storm criticals -- evictions must occur and resume clean
    longs = [
        SNNRequest(uid=100_000 + j, raster=(rng.random((12, NET.n_in)) < 0.3).astype(np.int32),
                   priority=Priority.BEST_EFFORT)
        for j in range(8)
    ]
    for r in longs:
        eng.submit(r)
    eng.poll()
    _check_lane_accounting(eng)
    crits = [
        SNNRequest(uid=200_000 + j, raster=(rng.random((6, NET.n_in)) < 0.3).astype(np.int32),
                   priority=Priority.CRITICAL)
        for j in range(4)
    ]
    for r in crits:
        eng.submit(r)
    while eng.in_flight:
        eng.poll()
        _check_lane_accounting(eng)
    assert eng.metrics.counters["preempted"] > 0
    assert all(r.status == "completed" for r in longs + crits)

    # sampled bit-exactness across terminal states
    oracle, serial = serial_oracle(device)
    completed = [r for r in reqs if r.status == "completed"]
    degraded = [r for r in reqs if r.status == "degraded"]
    for idx in rng.choice(len(completed), size=25, replace=False):
        r = completed[idx]
        np.testing.assert_array_equal(np.asarray(r.spike_counts),
                                      serial(NET, qparams, r.raster[: r.n_steps]), err_msg=oracle)
    for r in (longs + crits)[:4]:  # preemption-history samples
        np.testing.assert_array_equal(np.asarray(r.spike_counts),
                                      serial(NET, qparams, r.raster[: r.n_steps]), err_msg=oracle)
    for r in degraded[:10]:
        np.testing.assert_array_equal(
            np.asarray(r.spike_counts),
            serial(tier.net, tier.qparams, r.raster[: tier.steps(r.n_steps)]),
            err_msg=oracle,
        )
