"""Property suite: the port's scheduler invariants over randomized mixes.

``test_serve_sched_props.py``'s strategies and settings, pointed at the
port's ``SNNServeEngine`` on the CPU: conservation (every request terminal
exactly once), FIFO within (class, tenant), bit-exactness of every completed
request against a serial JAX ``run_int`` and of every degraded one at the
tier's precision and truncated window, and no starvation of the lowest
class.  Parameters are drawn by ``jax.random`` and cross through numpy.

hypothesis is a CI-only dependency (requirements-dev.txt): the module skips
cleanly where it isn't installed.
"""

import pytest

pytest.importorskip("hypothesis")

import jax
import jax.numpy as jnp
import numpy as np
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.serve import scheduler as jsched
from repro_torch.core import network as tnet
from repro_torch.core import snn_layer as tsl
from repro_torch.serve.scheduler import PrecisionTier, Priority, SchedPolicy
from repro_torch.serve.snn_engine import SNNRequest, SNNServeEngine


def _net(sl, nw):
    return nw.NetworkConfig(
        layers=(
            sl.LayerConfig(n_in=16, n_out=10, neuron=sl.NeuronModel.LIF, topology=sl.Topology.FF,
                           reset=sl.ResetMode.SUBTRACT, beta=0.9),
            sl.LayerConfig(n_in=10, n_out=4, neuron=sl.NeuronModel.LIF,
                           reset=sl.ResetMode.ZERO, beta=0.77),
        ),
        n_steps=8,
    )


JNET, NET = _net(jsl, jnet), _net(tsl, tnet)
JPARAMS = jnet.init_float_params(jax.random.PRNGKey(0), JNET)
PARAMS = tnet.float_params_from_numpy(
    NET, [tuple(np.asarray(x) for x in p) for p in JPARAMS], device="cpu"
)
QPARAMS, _ = tnet.quantize_params(NET, PARAMS)
TIER = PrecisionTier.from_params(NET, PARAMS, w_bits=3, steps_fraction=0.5)
JQPARAMS, _ = jnet.quantize_params(JNET, JPARAMS)
JTIER = jsched.PrecisionTier.from_params(JNET, JPARAMS, w_bits=3, steps_fraction=0.5)

_SERIAL_CACHE: dict = {}


def _serial(net, qparams, raster, T, key):
    """Serial JAX ``run_int``; the key holds the raster's bytes, so a cached
    count can never stand for another raster."""
    key = (key, T, np.asarray(raster).tobytes())
    if key not in _SERIAL_CACHE:
        x = np.asarray(raster)[:T]
        rec = jnet.run_int(net, qparams, jnp.asarray(x[:, None, :], jnp.int32))
        _SERIAL_CACHE[key] = np.asarray(rec.spike_counts)[0]
    return _SERIAL_CACHE[key]


# one request spec: (T, density, priority, tenant, deadline kind)
spec = st.tuples(
    st.integers(min_value=1, max_value=8),
    st.sampled_from([0.05, 0.3, 0.6]),
    st.sampled_from(list(Priority)),
    st.sampled_from(["a", "b"]),
    st.sampled_from([None, "easy", "mid", "expired"]),
)

workloads = st.tuples(
    st.lists(spec, min_size=1, max_size=10),
    st.integers(min_value=0, max_value=2**31 - 1),  # raster seed
    st.sampled_from([1, 2]),  # max_batch
    st.booleans(),  # preemption on/off
)

_DEADLINES = {None: None, "easy": 1e9, "mid": 0.45, "expired": 1e-9}


def _build(specs, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for uid, (T, rate, prio, tenant, dl) in enumerate(specs):
        raster = (rng.random((T, NET.n_in)) < rate).astype(np.int32)
        reqs.append(SNNRequest(uid=uid, raster=raster, priority=prio, tenant=tenant,
                               deadline_s=_DEADLINES[dl]))
    return reqs


def test_quantized_parameters_equal_jax():
    for got, want in zip(list(QPARAMS) + list(TIER.qparams), list(JQPARAMS) + list(JTIER.qparams)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@settings(max_examples=15, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(workloads)
def test_scheduler_invariants_hold_for_random_mixes(workload):
    specs, seed, max_batch, preempt = workload
    reqs = _build(specs, seed)
    terminal: dict[int, int] = {}
    for r in reqs:
        r.on_complete = lambda req: terminal.__setitem__(req.uid, terminal.get(req.uid, 0) + 1)
    eng = SNNServeEngine(
        NET, QPARAMS, max_batch=max_batch, tick_stride=4,
        scheduler=SchedPolicy(preempt=preempt, preempt_min_remaining_steps=2),
        precision_tiers=[TIER], device="cpu",
    )
    eng.metrics.seed_step_estimate(0.05)
    for r in reqs:
        eng.submit(r)
    done = eng.drain()

    assert sorted(r.uid for r in done) == sorted(r.uid for r in reqs)
    assert all(terminal.get(r.uid) == 1 for r in reqs)
    assert all(r.finished for r in reqs)
    assert not eng.in_flight and eng.free_lanes == eng.max_batch
    c = eng.metrics.counters
    assert c["completed"] + c["degraded"] + c["rejected"] == len(reqs)

    for cls in Priority:
        for tenant in ("a", "b"):
            seqs = [r.admitted_seq for r in reqs
                    if r.priority is cls and r.tenant == tenant and r.admitted_seq is not None]
            assert seqs == sorted(seqs)

    for r in reqs:
        if r.status == "completed":
            np.testing.assert_array_equal(
                np.asarray(r.spike_counts), _serial(JNET, JQPARAMS, r.raster, r.n_steps, "full")
            )
        elif r.status == "degraded":
            assert r.tier == TIER.name
            np.testing.assert_array_equal(
                np.asarray(r.spike_counts),
                _serial(JTIER.net, JTIER.qparams, r.raster, TIER.steps(r.n_steps), "tier"),
            )
        else:
            assert r.status == "rejected" and r.spike_counts is None


@settings(max_examples=10, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(min_value=0, max_value=2**31 - 1), st.integers(min_value=3, max_value=12))
def test_lowest_class_completes_under_critical_backlog(seed, n_critical):
    rng = np.random.default_rng(seed)
    eng = SNNServeEngine(NET, QPARAMS, max_batch=1, tick_stride=4, device="cpu")
    for uid in range(n_critical):
        eng.submit(SNNRequest(uid=uid, raster=(rng.random((4, NET.n_in)) < 0.3).astype(np.int32),
                              priority=Priority.CRITICAL))
    be = SNNRequest(uid=999, raster=(rng.random((4, NET.n_in)) < 0.3).astype(np.int32),
                    priority=Priority.BEST_EFFORT)
    eng.submit(be)
    done = eng.drain()
    assert be.status == "completed"
    assert be.admitted_seq == min(n_critical, 8)
    assert len(done) == n_critical + 1
