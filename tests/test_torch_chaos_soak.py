"""Chaos soak of the port: randomized multi-fault churn with sampled serial
replays, as ``test_chaos_soak.py`` drives JAX's.

Marked ``slow`` as JAX's is (a nightly-length run; tier-1 deselects it via
the default ``-m "not slow"``), and run on the CPU and, where there is one,
the card.  ``FaultInjector.from_seed`` derives a deterministic fault
schedule per round -- random mixes of tick exceptions, carry poisonings and
simulated process kills over the first dozens of ticks -- and a
``SupervisedEngine`` with a write-ahead journal must serve every admitted
request through it.

Invariants, every round: no request lost; no double-serve (with a
synchronous journal every completion is durable before its callback);
conservation at every poll (completed and engine-resident uids disjoint and
jointly covering every admission); and a sampled subset of results
bit-exact with a serial ``run_int``, however many restarts, quarantines and
journal replays the request lived through.

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
from repro_torch.core.snn_layer import LayerConfig, NeuronModel
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.snn_engine import SNNRequest, SNNServeEngine
from repro_torch.serve.supervisor import SupervisedEngine

SEED = 20260808
N_ROUNDS = 12
N_REQUESTS = 24
SAMPLES_PER_ROUND = 6

NET = NetworkConfig(
    layers=(
        LayerConfig(n_in=16, n_out=10, neuron=NeuronModel.LIF, beta=0.9),
        LayerConfig(n_in=10, n_out=4, neuron=NeuronModel.LIF, beta=0.77),
    ),
    n_steps=8,
)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _qparams():
    rng = np.random.default_rng(0)
    arrays = [
        (rng.uniform(-1, 1, (c.n_in, c.n_out)).astype(np.float32) / np.sqrt(c.n_in),
         np.zeros(0, np.float32), np.float32(c.threshold))
        for c in NET.layers
    ]
    return quantize_params(NET, float_params_from_numpy(NET, arrays, device="cpu"))[0]


QPARAMS = _qparams()


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_chaos_soak_randomized_faults_with_sampled_serial_replays(tmp_path, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    oracle, serial = serial_oracle(device)
    rng = np.random.default_rng(SEED)
    totals = {"tick": 0, "carry": 0, "kill": 0, "warm": 0, "cold": 0}
    for round_idx in range(N_ROUNDS):
        inj = FaultInjector.from_seed(
            int(rng.integers(2**31)),
            n_faults=int(rng.integers(2, 6)),
            horizon=24,
            sites=("tick", "carry", "kill"),
        )
        sup = SupervisedEngine(
            lambda: SNNServeEngine(NET, QPARAMS, max_batch=4, tick_stride=2, device=device),
            journal_dir=tmp_path / f"wal{round_idx}",
            journal_fsync_every=1,
            faults=inj,
            max_tick_retries=1,
            backoff_s=1e-4,
        )
        rasters = {}
        for uid in range(N_REQUESTS):
            T = int(rng.choice([4, 8]))
            raster = (rng.random((T, NET.n_in)) < 0.4).astype(np.uint8)
            rasters[uid] = raster
            sup.submit(SNNRequest(uid=uid, raster=raster))

        completed = {}
        while sup.in_flight:
            for req in sup.poll():
                assert req.uid not in completed, f"round {round_idx}: uid {req.uid} double-served"
                completed[req.uid] = req
            eng = sup.engine
            resident = {lane.req.uid for lane in eng._lanes if lane is not None}
            resident |= {r.uid for r in eng.sched}
            assert not (set(completed) & resident)
            assert set(completed) | resident == set(rasters), f"round {round_idx}: requests lost"
        assert sorted(completed) == sorted(rasters)

        for uid in rng.choice(N_REQUESTS, SAMPLES_PER_ROUND, replace=False):
            req = completed[int(uid)]
            assert req.status == "completed"
            np.testing.assert_array_equal(
                req.spike_counts, serial(NET, QPARAMS, rasters[int(uid)]),
                err_msg=f"round {round_idx} uid {uid}: not bit-exact vs {oracle}",
            )

        for site in ("tick", "carry", "kill"):
            totals[site] += sum(1 for s, _, _ in inj.fired if s == site)
        totals["warm"] += sup.metrics.counters["recoveries_warm"]
        totals["cold"] += sup.metrics.counters["recoveries_cold"]
        sup.close()

    # the schedule generator must actually have exercised the machinery
    assert totals["cold"] >= 1, f"no kill ever fired: {totals}"
    assert totals["tick"] + totals["carry"] >= 1, totals
