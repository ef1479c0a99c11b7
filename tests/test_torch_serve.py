"""The port's serving engine against JAX serial ``run_int`` (exact equality).

Every request served by ``repro_torch``'s ``SNNServeEngine`` -- dense lane
route, the in-pool ``event-pallas`` route, the over-budget fallback to the
dense route, the direct eager event route, graded ``int32`` ticks,
preemption and deadline degradation -- must give the spike counts and event
traffic of a serial single-sample ``run_int`` in the JAX package.  Ragged
window lengths with a small ``tick_stride`` make lanes complete mid-chunk
and get reused.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.serve import snn_engine as jeng
from repro_torch.core import backend as tbe
from repro_torch.core import network as tnet
from repro_torch.core import snn_layer as tsl
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.snn_engine import AsyncSNNServer, SNNRequest, SNNServeEngine


def _nets(n_in=24, T=9, topology="ff", neuron="lif", w_bits=6):
    def mk(sl, nw):
        return nw.NetworkConfig(
            layers=(
                sl.LayerConfig(n_in=n_in, n_out=12, neuron=sl.NeuronModel(neuron),
                               topology=sl.Topology(topology), reset=sl.ResetMode.SUBTRACT,
                               beta=0.9, w_bits=w_bits),
                sl.LayerConfig(n_in=12, n_out=5, neuron=sl.NeuronModel(neuron),
                               reset=sl.ResetMode.ZERO, beta=0.77, w_bits=w_bits),
            ),
            n_steps=T,
        )
    return mk(jsl, jnet), mk(tsl, tnet)


@dataclasses.dataclass
class Pair:
    jn: object
    tn: object
    jq: list
    tq: list
    params: list  # float params as numpy arrays

    def serial(self, raster):
        """JAX serial single-sample run_int (one compile per window length)."""
        return _jit_serial(self.jn)(self.jq, jnp.asarray(np.asarray(raster, np.int32)[:, None]))

    def assert_matches_serial(self, req):
        counts, in_ev, layer_ev = self.serial(req.raster)
        np.testing.assert_array_equal(req.spike_counts, np.asarray(counts)[0])
        assert req.prediction == int(np.argmax(np.asarray(counts)[0]))
        stats = req.event_stats
        np.testing.assert_array_equal(stats["input_events_per_step"], np.asarray(in_ev))
        for got, want in zip(stats["layer_events_per_step"], layer_ev):
            np.testing.assert_array_equal(got, np.asarray(want))


_JIT_CACHE = {}


def _jit_serial(jn):
    if jn not in _JIT_CACHE:
        def f(q, x):
            rec = jnet.run_int(jn, q, x)
            return (
                rec.spike_counts,
                jnp.mean(rec.input_events, axis=1),
                [jnp.mean(s, axis=1) for s in rec.layer_spikes],
            )
        _JIT_CACHE[jn] = jax.jit(f)
    return _JIT_CACHE[jn]


def _float_arrays(net, seed):
    """Float parameters from a numpy seed (uniform(+-1/sqrt(fan_in)) weights)."""
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


def _pair(seed=0, **kw):
    """Numpy-seeded weights, quantized by the port (bit-equal to JAX's
    ``quantize_params``, see test_torch_numerics.py), in both packages."""
    jn, tn = _nets(**kw)
    params = _float_arrays(tn, seed)
    tq, _ = tnet.quantize_params(tn, tnet.float_params_from_numpy(tn, params, device="cpu"))
    jq = [jsl.IntLayerParams(*(jnp.asarray(a.numpy()) for a in p)) for p in tq]
    return Pair(jn, tn, jq, tq, params)


def _rasters(n_in, lengths, seed=1, rate=0.3):
    rng = np.random.default_rng(seed)
    return [(rng.random((T, n_in)) < rate).astype(np.int32) for T in lengths]


def _engine(p, **kw):
    kw.setdefault("device", "cpu")
    return SNNServeEngine(p.tn, p.tq, **kw)


@pytest.mark.parametrize("tick_stride", [1, 4, None])
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_dense_lane_route_bit_exact_ragged(backend, tick_stride):
    """Ragged windows on a 3-lane pool: lanes complete mid-chunk and are
    reused by the queue; every request matches JAX serial run_int."""
    p = _pair()
    engine = _engine(p, max_batch=3, backend=backend, tick_stride=tick_stride)
    lengths = [9, 3, 7, 5, 9, 2, 6]
    reqs = [SNNRequest(uid=i, raster=r) for i, r in enumerate(_rasters(24, lengths))]
    done = engine.run(reqs)
    assert sorted(r.uid for r in done) == list(range(len(lengths)))
    assert engine.active_lanes == 0 and engine.free_lanes == 3
    assert {r.route for r in done} == {"lanes"}
    assert engine.n_ticks > 0
    for req in done:
        assert req.status == "completed" and req.tier == "full" and req.latency_s >= 0
        p.assert_matches_serial(req)


@pytest.mark.parametrize("topology,neuron", [("ata_t", "lif"), ("ata_f", "synaptic")])
def test_recurrent_cores_serve_bit_exact(topology, neuron):
    p = _pair(topology=topology, neuron=neuron)
    engine = _engine(p, max_batch=2, tick_stride=2)
    done = engine.run([SNNRequest(uid=i, raster=r) for i, r in enumerate(_rasters(24, [9, 4, 6]))])
    for req in done:
        p.assert_matches_serial(req)


def test_event_pallas_route_and_over_budget_fallback():
    """Sparse requests ride the in-pool sparse route, dense ones the lane
    route, and a request with one step over the budget falls back to the
    dense route -- all bit-exact."""
    p = _pair()
    engine = _engine(p, max_batch=2, backend=tbe.EventBackend("pallas"),
                     sparse_admission_threshold=0.10, tick_stride=4)
    assert engine._event_budget == 16
    rng = np.random.default_rng(5)
    sparse = [(rng.random((T, 24)) < 0.04).astype(np.int32) for T in (9, 4, 7)]
    dense = [(rng.random((9, 24)) < 0.40).astype(np.int32) for _ in range(2)]
    reqs = [SNNRequest(uid=i, raster=r) for i, r in enumerate(sparse + dense)]
    done = engine.run(reqs)
    by_uid = {r.uid: r for r in done}
    assert all(by_uid[i].route == "event-pallas" for i in range(3))
    assert all(by_uid[i].route == "lanes" for i in range(3, 5))
    for req in done:
        p.assert_matches_serial(req)

    tight = _engine(p, max_batch=2, backend=tbe.EventBackend("pallas", event_budget=2,
                                                             capacity_multiple=1))
    hot = np.zeros((9, 24), np.int32)
    hot[0, :5] = 1  # one step with 5 events > budget 2; mean density stays low
    (req,) = tight.run([SNNRequest(uid=0, raster=hot)])
    assert req.route == "lanes"
    p.assert_matches_serial(req)


@pytest.mark.parametrize("strategy,route", [("gather", "event-gather"), ("auto", "event-csr")])
def test_direct_event_route(strategy, route):
    p = _pair()
    engine = _engine(p, max_batch=1, backend=tbe.EventBackend(strategy))
    rng = np.random.default_rng(2)
    sparse = (rng.random((7, 24)) < 0.05).astype(np.int32)
    dense = (rng.random((5, 24)) < 0.5).astype(np.int32)
    done = engine.run([SNNRequest(uid=0, raster=dense), SNNRequest(uid=1, raster=sparse)])
    by_uid = {r.uid: r for r in done}
    assert by_uid[1].route == route and by_uid[0].route == "lanes"
    for req in done:
        p.assert_matches_serial(req)


def test_graded_inputs_take_int32_ticks():
    """Values above the f32 certificate force ff_mode="int32" (the exact
    product) for the whole cohort; moderate graded values stay f32-exact."""
    p = _pair(w_bits=16)
    engine = _engine(p, max_batch=2)
    assert engine._f32_input_max < 300
    rng = np.random.default_rng(4)
    big = ((rng.random((6, 24)) < 0.3) * rng.integers(1, 2000, (6, 24))).astype(np.int32)
    small = ((rng.random((6, 24)) < 0.3) * rng.integers(1, 3, (6, 24))).astype(np.int32)
    modes = []
    advance = engine._advance
    engine._advance = lambda x, meta, ff_mode, budget: modes.append(ff_mode) or advance(
        x, meta, ff_mode, budget
    )
    done = engine.run([SNNRequest(uid=0, raster=big), SNNRequest(uid=1, raster=small)])
    assert "int32" in modes
    for req in done:
        p.assert_matches_serial(req)


def test_port_engine_matches_jax_engine():
    """Same requests through both engines (pallas event backend, ragged,
    sparse + dense): identical counts, routes and per-request traffic."""
    p = _pair()
    rng = np.random.default_rng(9)
    rasters = [(rng.random((T, 24)) < rate).astype(np.int32)
               for T, rate in [(9, 0.03), (5, 0.4), (8, 0.05), (3, 0.3), (9, 0.02)]]
    t_done = _engine(p, max_batch=2, backend=tbe.EventBackend("pallas"), tick_stride=4).run(
        [SNNRequest(uid=i, raster=r) for i, r in enumerate(rasters)]
    )
    j_done = jeng.SNNServeEngine(
        p.jn, p.jq, max_batch=2, backend=jeng.EventBackend("pallas"), tick_stride=4
    ).run([jeng.SNNRequest(uid=i, raster=r) for i, r in enumerate(rasters)])
    t_by, j_by = {r.uid: r for r in t_done}, {r.uid: r for r in j_done}
    for uid in range(len(rasters)):
        a, b = t_by[uid], j_by[uid]
        np.testing.assert_array_equal(a.spike_counts, b.spike_counts)
        assert (a.route, a.prediction, a.status) == (b.route, b.prediction, b.status)
        for key in ("input_events_per_step",):
            np.testing.assert_array_equal(a.event_stats[key], b.event_stats[key])
        for x, y in zip(a.event_stats["layer_events_per_step"], b.event_stats["layer_events_per_step"]):
            np.testing.assert_array_equal(x, y)
        assert dataclasses.astuple(a.design) == dataclasses.astuple(b.design)


def test_preempted_request_resumes_bit_exact():
    p = _pair()
    engine = _engine(p, max_batch=1, tick_stride=2)
    long_r, urgent = _rasters(24, [9, 4], seed=3)
    victim = SNNRequest(uid=0, raster=long_r)
    engine.submit(victim)
    engine.poll()  # victim admitted and advanced one chunk
    engine.submit(SNNRequest(uid=1, raster=urgent, priority=tsched.Priority.CRITICAL))
    done = engine.drain()
    assert [r.uid for r in done] == [1, 0]
    assert victim.preemptions == 1 and engine.metrics.counters["resumed"] == 1
    for req in done:
        p.assert_matches_serial(req)


def test_deadline_degradation_serves_tier_bit_exact():
    p = _pair()
    params = tnet.float_params_from_numpy(p.tn, p.params, device="cpu")
    tier = tsched.PrecisionTier.from_params(p.tn, params, w_bits=3)
    engine = _engine(p, max_batch=1, tick_stride=2, precision_tiers=[tier])
    busy = SNNRequest(uid=0, raster=_rasters(24, [9])[0])
    engine.submit(busy)
    engine.poll()
    # 1 s a step: 8 s cannot cover the 7-step backlog plus 6 steps, but an
    # immediate 6-step tier serve can (2 s of slack for a loaded host)
    engine.metrics.seed_step_estimate(1.0)
    late = SNNRequest(uid=1, raster=_rasters(24, [6], seed=8)[0], deadline_s=8.0)
    engine.submit(late)
    done = engine.drain()
    assert late.status == "degraded" and late.tier == "w3" and late.route == "degraded"
    # the tier's JAX twin: same float params re-quantized at w_bits=3
    jcoarse = p.jn.replace_precisions(w_bits=3)
    jq3, _ = jnet.quantize_params(jcoarse, [jsl.FloatLayerParams(*map(jnp.asarray, a)) for a in p.params])
    want = jnet.run_int(jcoarse, jq3, jnp.asarray(late.raster.astype(np.int32)[:, None]))
    np.testing.assert_array_equal(late.spike_counts, np.asarray(want.spike_counts)[0])
    assert busy in done and busy.status == "completed"
    p.assert_matches_serial(busy)


def test_warmup_leaves_engine_clean_and_serves():
    p = _pair()
    engine = _engine(p, max_batch=2, backend=tbe.EventBackend("pallas"))
    engine.warmup(include_int32=True)
    assert not engine.in_flight and engine.n_served == 0
    assert engine.metrics.snapshot()["ticks"] == 0
    for st in engine._states:
        assert all(not a.any() for a in st)
    (req,) = engine.run([SNNRequest(uid=0, raster=_rasters(24, [9])[0])])
    p.assert_matches_serial(req)


def test_async_server_resolves_futures():
    p = _pair()
    engine = _engine(p, max_batch=2)
    reqs = [SNNRequest(uid=i, raster=r) for i, r in enumerate(_rasters(24, [4, 7, 2]))]
    done = asyncio.run(AsyncSNNServer(engine).serve(reqs))
    assert [r.uid for r in done] == [0, 1, 2]
    for req in done:
        p.assert_matches_serial(req)


def test_engine_validation_and_device(tmp_path):
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.journal import Journal, read_records

    p = _pair()
    # journal= and faults= are taken, as in the JAX engine
    inj = FaultInjector()
    with Journal(tmp_path / "wal") as journal:
        engine = _engine(p, journal=journal, faults=inj)
        assert engine.journal is journal and engine.faults is inj
        engine.run([SNNRequest(uid=3, raster=_rasters(24, [5])[0])])
        engine.stop_admission = True
        with pytest.raises(RuntimeError, match="admission is stopped"):
            engine.submit(SNNRequest(uid=4, raster=_rasters(24, [5])[0]))
    assert [(r.kind, r.fields["uid"]) for r in read_records(tmp_path / "wal")] == [
        ("submit", 3), ("done", 3)]
    assert inj.counts["tick"] == engine.n_ticks > 0
    assert _engine(p, data_parallel=4).data_parallel == 1
    with pytest.raises(ValueError, match="channels"):
        _engine(p).submit(SNNRequest(uid=0, raster=np.zeros((3, 7), np.int32)))
    with pytest.raises(ValueError, match="empty window"):
        SNNRequest(uid=0, raster=np.zeros((0, 24), np.int32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SNNServeEngine(p.tn, p.tq)
    engine = _engine(p, max_batch=1)
    calls = []
    done = engine.run([SNNRequest(uid=0, raster=_rasters(24, [3])[0],
                                  on_complete=lambda r: calls.append(r.uid) or 1 / 0)])
    assert calls == [0] and engine.metrics.counters["callback_failures"] == 1
    snap = engine.metrics.snapshot()
    assert snap["counters"]["completed"] == 1 and snap["counters"]["route:lanes"] == 1
    assert done[0].design.latency_s > 0
