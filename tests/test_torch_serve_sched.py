"""The port's front-line scheduler, case for case with ``test_serve_sched.py``.

Every case of the JAX battery, pointed at ``repro_torch``: class-credit DRR,
tenant WFQ, requeue semantics and deadline verdicts on the port's
``Scheduler`` alone; the rolling window and Prometheus text of its
``ServeMetrics``; and the engine's preemption, degradation, rejection,
stall guard and callback containment, where every completed request equals
a serial JAX ``run_int`` of its raster and every degraded one a serial JAX
``run_int`` at the tier's precision over the tier's truncated window.

Float parameters come from ``jax.random`` and cross through numpy; the port
quantizes them (bit-equal to JAX's ``quantize_params``, asserted in the
fixture).  One more case drives the same operation sequence through JAX's
``Scheduler`` and the port's and requires the same order and snapshots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.serve import scheduler as jsched
from repro.serve import snn_engine as jeng
from repro_torch.core import network as tnet
from repro_torch.core import snn_layer as tsl
from repro_torch.serve.metrics import RollingWindow, ServeMetrics
from repro_torch.serve.scheduler import PrecisionTier, Priority, SchedPolicy, Scheduler
from repro_torch.serve.snn_engine import EngineStalledError, SNNRequest, SNNServeEngine


def _make_net(sl, nw, T=16, n_in=24):
    return nw.NetworkConfig(
        layers=(
            sl.LayerConfig(n_in=n_in, n_out=12, neuron=sl.NeuronModel.LIF,
                           topology=sl.Topology.FF, reset=sl.ResetMode.SUBTRACT, beta=0.9),
            sl.LayerConfig(n_in=12, n_out=5, neuron=sl.NeuronModel.LIF,
                           reset=sl.ResetMode.ZERO, beta=0.77),
        ),
        n_steps=T,
    )


def _params(seed, T=16, n_in=24):
    """JAX-drawn float parameters in both packages: (jax net, jax params,
    port net, port params on the CPU)."""
    jn, tn = _make_net(jsl, jnet, T, n_in), _make_net(tsl, tnet, T, n_in)
    jp = jnet.init_float_params(jax.random.PRNGKey(seed), jn)
    arrays = [tuple(np.asarray(x) for x in p) for p in jp]
    return jn, jp, tn, tnet.float_params_from_numpy(tn, arrays, device="cpu")


class _Oracle:
    """Serial JAX ``run_int`` at full precision and at the tier's."""

    def __init__(self, jn, jp):
        self.jq, _ = jnet.quantize_params(jn, jp)
        self.jn = jn
        jt = jsched.PrecisionTier.from_params(jn, jp, w_bits=3, steps_fraction=0.5)
        self.tier_net, self.tier_q = jt.net, jt.qparams

    @staticmethod
    def _run(net, qparams, raster, T):
        x = np.asarray(raster)[:T]
        rec = jnet.run_int(net, qparams, jnp.asarray(x[:, None, :], jnp.int32))
        return np.asarray(rec.spike_counts)[0]

    def full(self, raster, T=None):
        return self._run(self.jn, self.jq, raster, T or len(raster))

    def tier(self, raster, T):
        return self._run(self.tier_net, self.tier_q, raster, T)


@pytest.fixture(scope="module")
def setup():
    jn, jp, net, params = _params(0)
    qparams, _ = tnet.quantize_params(net, params)
    tier = PrecisionTier.from_params(net, params, w_bits=3, steps_fraction=0.5)
    oracle = _Oracle(jn, jp)
    for got, want in zip(qparams, oracle.jq):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for got, want in zip(tier.qparams, oracle.tier_q):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return net, params, qparams, tier, oracle


def _raster(T, n_in=24, seed=1, rate=0.4):
    rng = np.random.default_rng(seed)
    return (rng.random((T, n_in)) < rate).astype(np.int32)


def _req(uid, T=8, seed=None, **kw):
    return SNNRequest(uid=uid, raster=_raster(T, seed=uid if seed is None else seed), **kw)


def _engine(net, qparams, **kw):
    return SNNServeEngine(net, qparams, device="cpu", **kw)


# -- scheduler unit tests (no engine, no device work) ------------------------


def test_default_policy_degenerates_to_fifo():
    sched = Scheduler()
    reqs = [_req(i, T=4) for i in range(10)]
    for r in reqs:
        sched.add(r)
    assert [sched.pop().uid for _ in range(10)] == list(range(10))
    assert sched.pop() is None


def test_class_priority_order_under_credits():
    sched = Scheduler()
    for uid, cls in enumerate([Priority.BEST_EFFORT, Priority.STANDARD, Priority.CRITICAL] * 2):
        sched.add(_req(uid, T=4, priority=cls))
    popped = [sched.pop().priority for _ in range(6)]
    # class-major within one credit cycle: all queued criticals drain first
    assert popped == sorted(popped)


def test_drr_keeps_lowest_class_starvation_free():
    sched = Scheduler()  # weights (8, 3, 1): one BEST_EFFORT per cycle
    for i in range(100):
        sched.add(_req(i, T=4, priority=Priority.CRITICAL))
    for i in range(100, 105):
        sched.add(_req(i, T=4, priority=Priority.BEST_EFFORT))
    popped = [sched.pop() for _ in range(54)]
    n_be = sum(r.priority is Priority.BEST_EFFORT for r in popped)
    # 54 pops under sustained critical backlog = 6 DRR cycles of 8C + 1BE
    assert n_be == 5
    assert popped[0].priority is Priority.CRITICAL


def test_tenant_wfq_shares_work_by_weight():
    sched = Scheduler(SchedPolicy(tenant_weights={"heavy": 2.0, "light": 1.0}))
    for i in range(30):
        sched.add(_req(i, T=4, tenant="heavy"))
        sched.add(_req(100 + i, T=4, tenant="light"))
    popped = [sched.pop() for _ in range(30)]
    heavy = sum(r.tenant == "heavy" for r in popped)
    assert 17 <= heavy <= 23


def test_idle_tenant_reactivation_banks_no_credit():
    sched = Scheduler()
    for i in range(8):
        sched.add(_req(i, T=8, tenant="a"))
    for _ in range(6):
        sched.pop()
    for i in range(10, 14):
        sched.add(_req(i, T=8, tenant="b"))
    popped = [sched.pop().tenant for _ in range(4)]
    assert popped.count("b") <= 2


def test_requeue_front_restores_position():
    sched = Scheduler()
    for i in range(3):
        sched.add(_req(i, T=4))
    first = sched.pop()
    sched.requeue_front(first)
    assert sched.pop() is first
    assert sched[0].uid == 1


def test_remove_and_iteration_order():
    sched = Scheduler()
    reqs = [
        _req(0, T=4, priority=Priority.BEST_EFFORT),
        _req(1, T=4, priority=Priority.CRITICAL),
        _req(2, T=4, priority=Priority.STANDARD),
    ]
    for r in reqs:
        sched.add(r)
    assert [r.uid for r in sched] == [1, 2, 0]
    assert len(sched) == 3 and bool(sched)
    assert sched.remove(reqs[2]) and not sched.remove(reqs[2])
    assert [r.uid for r in sched] == [1, 0]


def test_deadline_action_keep_degrade_reject(setup):
    net, params, qparams, tier, _ = setup
    sched = Scheduler()
    req = _req(0, T=16, deadline_s=1.0)
    req._arrival_wall = 100.0
    tiers = (tier,)
    assert sched.deadline_action(req, 100.0, est_step_s=0.01, est_wait_s=0.0,
                                 tiers=tiers) == ("keep", None)
    action, got = sched.deadline_action(req, 100.5, est_step_s=0.05, est_wait_s=0.5, tiers=tiers)
    assert action == "degrade" and got is tier
    assert sched.deadline_action(req, 100.99, est_step_s=0.05, est_wait_s=0.0,
                                 tiers=tiers) == ("reject", None)
    assert sched.deadline_action(req, 102.0, est_step_s=None, est_wait_s=0.0,
                                 tiers=()) == ("reject", None)


def test_deadline_safety_degrades_earlier(setup):
    net, params, qparams, tier, _ = setup
    req = _req(0, T=16, deadline_s=1.0)
    req._arrival_wall = 0.0
    assert Scheduler(SchedPolicy(deadline_safety=1.0)).deadline_action(
        req, 0.0, est_step_s=0.05, est_wait_s=0.0, tiers=(tier,)
    )[0] == "keep"
    assert Scheduler(SchedPolicy(deadline_safety=2.0)).deadline_action(
        req, 0.0, est_step_s=0.05, est_wait_s=0.0, tiers=(tier,)
    )[0] == "degrade"


def test_policy_validation():
    with pytest.raises(ValueError, match="one weight per class"):
        SchedPolicy(class_weights=(1, 2))
    with pytest.raises(ValueError, match="starves"):
        SchedPolicy(class_weights=(8, 0, 1))
    with pytest.raises(ValueError, match="deadline_safety"):
        SchedPolicy(deadline_safety=0.0)
    with pytest.raises(ValueError, match="tenant_weights"):
        SchedPolicy(tenant_weights={"a": -1.0})


def test_precision_tier_validation(setup):
    net, params, qparams, tier, _ = setup
    with pytest.raises(ValueError, match="steps_fraction"):
        PrecisionTier(name="bad", net=net, qparams=qparams, steps_fraction=0.0)
    assert tier.name == "w3-t0.5"
    assert tier.steps(16) == 8 and tier.steps(1) == 1
    assert tier.net.layers[0].w_bits == 3


def test_scheduler_snapshot_structure():
    sched = Scheduler()
    sched.add(_req(7, T=4, priority=Priority.CRITICAL, tenant="a"))
    snap = sched.snapshot()
    assert snap["depth"] == 1
    assert snap["classes"]["CRITICAL"]["a"] == [7]
    assert set(snap["credits"]) == {"CRITICAL", "STANDARD", "BEST_EFFORT", "STREAMING"}


def test_invalid_priority_rejected():
    with pytest.raises(ValueError):
        _req(0, T=4, priority=7)


# -- metrics unit tests -------------------------------------------------------


def test_rolling_window_evicts_by_time():
    w = RollingWindow(window_s=10.0)
    w.add(1.0, now=0.0)
    w.add(5.0, now=9.0)
    assert w.values(now=9.5) == [1.0, 5.0]
    assert w.values(now=11.0) == [5.0]
    assert w.total_count == 2
    with pytest.raises(ValueError):
        RollingWindow(window_s=0.0)


def test_rolling_window_percentiles():
    w = RollingWindow(window_s=100.0)
    for v in range(1, 101):
        w.add(float(v), now=0.0)
    assert w.percentile(50, now=0.0) in (50.0, 51.0)
    assert w.percentile(99, now=0.0) == 99.0
    assert w.mean(now=0.0) == pytest.approx(50.5)


def test_metrics_prometheus_exposition():
    m = ServeMetrics()
    m.inc("submitted", 3)
    m.record_tick(4, 0.01, queue_depth=2, active=1, n_lanes=2, now=0.0)
    text = m.prometheus_text(now=0.0)
    assert 'neura_requests_total{outcome="submitted"} 3' in text
    assert "neura_queue_depth 2" in text
    assert "neura_lane_occupancy 0.5" in text
    assert m.est_step_s == pytest.approx(0.0025)


# -- engine integration --------------------------------------------------------


def test_preemption_resumes_bit_exact(setup):
    net, params, qparams, tier, oracle = setup
    eng = _engine(net, qparams, max_batch=2, tick_stride=4,
                  scheduler=SchedPolicy(preempt_min_remaining_steps=2))
    longs = [_req(i, T=16, priority=Priority.BEST_EFFORT) for i in range(2)]
    for r in longs:
        eng.submit(r)
    eng.poll()
    crit = _req(2, T=8, priority=Priority.CRITICAL)
    eng.submit(crit)
    done = eng.drain()
    assert {r.uid for r in done} == {0, 1, 2}
    assert crit.preemptions == 0
    assert sum(r.preemptions for r in longs) >= 1
    assert eng.metrics.counters["preempted"] >= 1
    assert eng.metrics.counters["resumed"] == eng.metrics.counters["preempted"]
    for r in longs + [crit]:
        assert r.status == "completed" and r.tier == "full"
        np.testing.assert_array_equal(np.asarray(r.spike_counts), oracle.full(r.raster))


def test_preemption_respects_policy_gates(setup):
    net, params, qparams, tier, _ = setup
    eng = _engine(net, qparams, max_batch=1, tick_stride=4,
                  scheduler=SchedPolicy(preempt_min_remaining_steps=100))
    long = _req(0, T=16, priority=Priority.BEST_EFFORT)
    eng.submit(long)
    eng.poll()
    eng.submit(_req(1, T=8, priority=Priority.CRITICAL))
    eng.drain()
    assert long.preemptions == 0 and eng.metrics.counters["preempted"] == 0
    eng2 = _engine(net, qparams, max_batch=1, tick_stride=4, scheduler=SchedPolicy(preempt=False))
    long2 = _req(0, T=16, priority=Priority.BEST_EFFORT)
    eng2.submit(long2)
    eng2.poll()
    eng2.submit(_req(1, T=8, priority=Priority.CRITICAL))
    eng2.drain()
    assert long2.preemptions == 0 and eng2.metrics.counters["preempted"] == 0


def test_max_preemptions_caps_evictions(setup):
    net, params, qparams, tier, oracle = setup
    eng = _engine(net, qparams, max_batch=1, tick_stride=4,
                  scheduler=SchedPolicy(max_preemptions=1, preempt_min_remaining_steps=1))
    victim = _req(0, T=16, priority=Priority.BEST_EFFORT)
    eng.submit(victim)
    eng.poll()
    eng.submit(_req(1, T=8, priority=Priority.CRITICAL))
    eng.poll()
    assert victim.preemptions == 1
    eng.submit(_req(2, T=8, priority=Priority.CRITICAL))
    done = eng.drain()
    assert victim.preemptions == 1
    assert {r.uid for r in done if r.status == "completed"} == {0, 1, 2}
    np.testing.assert_array_equal(np.asarray(victim.spike_counts), oracle.full(victim.raster))


def test_priority_admission_order(setup):
    net, params, qparams, tier, _ = setup
    eng = _engine(net, qparams, max_batch=1, tick_stride=4, scheduler=SchedPolicy(preempt=False))
    eng.submit(_req(9, T=16))
    eng.poll()
    be = _req(0, T=4, priority=Priority.BEST_EFFORT)
    std = _req(1, T=4, priority=Priority.STANDARD)
    crit = _req(2, T=4, priority=Priority.CRITICAL)
    for r in (be, std, crit):
        eng.submit(r)
    eng.drain()
    assert crit.admitted_seq < std.admitted_seq < be.admitted_seq


def test_degrade_serves_bit_exact_at_tier(setup):
    net, params, qparams, tier, oracle = setup
    eng = _engine(net, qparams, max_batch=2, scheduler=SchedPolicy(preempt=False),
                  precision_tiers=[tier])
    eng.metrics.seed_step_estimate(0.05)
    for u in range(2):
        eng.submit(_req(u, T=16, priority=Priority.BEST_EFFORT))
    deg = _req(10, T=16, deadline_s=0.5)
    rej = _req(11, T=16, deadline_s=0.01)
    eng.submit(deg)
    eng.submit(rej)
    done = eng.drain()
    assert {r.uid for r in done} == {0, 1, 10, 11}
    assert deg.status == "degraded" and deg.tier == tier.name and deg.route == "degraded"
    np.testing.assert_array_equal(np.asarray(deg.spike_counts),
                                  oracle.tier(deg.raster, tier.steps(16)))
    assert rej.status == "rejected" and rej.spike_counts is None
    assert rej.latency_s is not None
    assert eng.metrics.counters["degraded"] == 1
    assert eng.metrics.counters["rejected"] == 1
    assert deg.design is not None


def test_degrade_express_batch_chunks_by_pool_size(setup):
    net, params, qparams, tier, oracle = setup
    eng = _engine(net, qparams, max_batch=2, scheduler=SchedPolicy(preempt=False),
                  precision_tiers=[tier])
    eng.metrics.seed_step_estimate(0.05)
    for u in range(2):
        eng.submit(_req(u, T=16, priority=Priority.BEST_EFFORT))
    degs = [_req(10 + i, T=16, deadline_s=0.5) for i in range(5)]
    for r in degs:
        eng.submit(r)
    eng.drain()
    for r in degs:
        assert r.status == "degraded"
        np.testing.assert_array_equal(np.asarray(r.spike_counts),
                                      oracle.tier(r.raster, tier.steps(16)))


def test_generous_deadline_keeps_full_precision(setup):
    net, params, qparams, tier, _ = setup
    eng = _engine(net, qparams, max_batch=2, precision_tiers=[tier])
    req = _req(0, T=16, deadline_s=1e9)
    eng.submit(req)
    eng.drain()
    assert req.status == "completed" and req.tier == "full"


def test_expired_deadline_rejects_without_estimate(setup):
    net, params, qparams, tier, _ = setup
    eng = _engine(net, qparams, max_batch=2)
    req = _req(0, T=16, deadline_s=1e-9)
    eng.submit(req)
    done = eng.drain()
    assert done == [req] and req.status == "rejected"


def test_max_idle_ticks_raises_diagnosable_stall(setup):
    net, params, qparams, tier, _ = setup
    eng = _engine(net, qparams, max_batch=1, max_idle_ticks=5)

    class Wedged(Scheduler):
        def pop(self):
            return None

    eng.sched = Wedged()
    eng.sched.add(_req(99, T=4))
    with pytest.raises(EngineStalledError, match="no progress for 5") as exc:
        eng.drain()
    assert exc.value.queue_snapshot["depth"] == 1
    assert exc.value.queue_snapshot["classes"]["STANDARD"]["default"] == [99]
    assert exc.value.lane_states == [None]
    with pytest.raises(ValueError, match="max_idle_ticks"):
        _engine(net, qparams, max_idle_ticks=0)


def test_idle_counter_resets_on_progress(setup):
    net, params, qparams, tier, _ = setup
    eng = _engine(net, qparams, max_batch=1, max_idle_ticks=3)
    for u in range(3):
        eng.submit(_req(u, T=8))
    assert len(eng.drain()) == 3
    assert eng._idle_rounds == 0


def test_callback_failure_is_contained(setup):
    net, params, qparams, tier, _ = setup
    eng = _engine(net, qparams, max_batch=2)
    seen = []

    def bad(req):
        seen.append(req.uid)
        raise RuntimeError("boom")

    for r in [_req(u, T=8, on_complete=bad) for u in range(3)]:
        eng.submit(r)
    done = eng.drain()
    assert len(done) == 3 and all(r.status == "completed" for r in done)
    assert sorted(seen) == [0, 1, 2]
    assert eng.metrics.counters["callback_failures"] == 3
    assert eng.free_lanes == eng.max_batch


def test_queue_facade_backcompat(setup):
    net, params, qparams, tier, _ = setup
    eng = _engine(net, qparams, max_batch=1)
    assert not eng.queue and len(eng.queue) == 0
    eng.submit(_req(5, T=4))
    eng.submit(_req(6, T=4))
    assert eng.queue and len(eng.queue) == 2
    assert eng.queue[0].uid == 5 and [r.uid for r in eng.queue] == [5, 6]
    eng.drain()
    assert not eng.queue


def test_request_conservation_under_mixed_load(setup):
    net, params, qparams, tier, oracle = setup
    eng = _engine(net, qparams, max_batch=2, tick_stride=4, precision_tiers=[tier])
    eng.metrics.seed_step_estimate(0.02)
    terminal = {}

    def note(req):
        terminal[req.uid] = terminal.get(req.uid, 0) + 1

    rng = np.random.default_rng(3)
    reqs = []
    for uid in range(18):
        cls = Priority(int(rng.integers(0, 3)))
        deadline = [None, 1e9, 0.4, 1e-9][int(rng.integers(0, 4))]
        reqs.append(
            SNNRequest(uid=uid, raster=_raster(int(rng.integers(4, 17)), seed=uid),
                       priority=cls, tenant=["a", "b"][uid % 2],
                       deadline_s=deadline, on_complete=note)
        )
    for r in reqs:
        eng.submit(r)
    done = eng.drain()
    assert sorted(r.uid for r in done) == list(range(18))
    assert all(n == 1 for n in terminal.values()) and len(terminal) == 18
    counts = eng.metrics.counters
    assert counts["completed"] + counts["degraded"] + counts["rejected"] == 18
    assert eng.free_lanes == eng.max_batch and not eng.queue
    for r in reqs:
        if r.status == "completed":
            np.testing.assert_array_equal(np.asarray(r.spike_counts), oracle.full(r.raster))
        elif r.status == "degraded":
            np.testing.assert_array_equal(np.asarray(r.spike_counts),
                                          oracle.tier(r.raster, tier.steps(r.n_steps)))


def test_metrics_reflect_served_traffic(setup):
    net, params, qparams, tier, _ = setup
    eng = _engine(net, qparams, max_batch=2)
    for u in range(4):
        eng.submit(_req(u, T=8, priority=Priority.CRITICAL if u % 2 else Priority.STANDARD))
    eng.drain()
    snap = eng.metrics.snapshot()
    assert snap["counters"]["completed"] == 4
    assert snap["latency"]["critical"]["window_count"] == 2
    assert snap["latency"]["standard"]["window_count"] == 2
    assert snap["latency"]["all"]["p99_ms"] >= snap["latency"]["all"]["p50_ms"]
    assert snap["ticks"] == eng.n_ticks > 0
    assert eng.metrics.est_step_s is not None and eng.metrics.est_step_s > 0
    assert snap["tick_s"] > 0
    text = eng.metrics.prometheus_text()
    assert 'neura_requests_total{outcome="completed"} 4' in text
    assert 'neura_route_requests_total{route="lanes"} 4' in text


def test_warmup_covers_tier_programs_and_resets_metrics(setup):
    net, params, qparams, tier, _ = setup
    eng = _engine(net, qparams, max_batch=2, precision_tiers=[tier])
    eng.warmup()
    assert eng.n_served == 0 and not eng.in_flight
    assert eng.metrics.counters["submitted"] == 0
    assert eng.metrics.n_ticks == 0


def test_tier_topology_mismatch_rejected(setup):
    net, params, qparams, tier, _ = setup
    _, _, other, oparams = _params(1, n_in=10)
    bad = PrecisionTier.from_params(other, oparams, w_bits=3)
    with pytest.raises(ValueError, match="topology"):
        _engine(net, qparams, precision_tiers=[bad])


# -- the same operations on JAX's scheduler and the port's --------------------


def test_scheduler_matches_jax_op_for_op():
    """A seeded mix of add / pop / pop_class / requeue_front / remove, with
    tenant weights and all four classes, on both packages' ``Scheduler``:
    the same uid comes out of every pop, every ``remove`` agrees, and the
    order and ``snapshot()`` are equal after every operation."""
    policy = dict(tenant_weights={"a": 2.0, "b": 1.0, "c": 0.5})
    jax_s = jsched.Scheduler(jsched.SchedPolicy(**policy))
    port_s = Scheduler(SchedPolicy(**policy))
    rng = np.random.default_rng(11)
    queued: dict[int, tuple] = {}  # uid -> (jax request, port request)
    popped: list[tuple] = []
    next_uid = n_pops = 0
    for step in range(400):
        op = rng.choice(["add", "add", "pop", "pop_class", "requeue", "remove"])
        if op == "add":
            T = int(rng.integers(1, 20))
            kw = dict(priority=int(rng.integers(0, 4)), tenant=str(rng.choice(["a", "b", "c"])))
            raster = _raster(T, seed=next_uid)
            pair = (jeng.SNNRequest(uid=next_uid, raster=raster, **kw),
                    SNNRequest(uid=next_uid, raster=raster, **kw))
            jax_s.add(pair[0])
            port_s.add(pair[1])
            queued[next_uid] = pair
            next_uid += 1
        elif op in ("pop", "pop_class"):
            if op == "pop":
                a, b = jax_s.pop(), port_s.pop()
            else:
                cls = int(rng.integers(0, 4))
                a, b = jax_s.pop_class(jsched.Priority(cls)), port_s.pop_class(Priority(cls))
            assert (a and a.uid) == (b and b.uid), f"step {step}: {op}"
            if a is not None:
                popped.append(queued.pop(a.uid))
                n_pops += 1
        elif op == "requeue" and popped:
            a, b = popped.pop(int(rng.integers(0, len(popped))))
            jax_s.requeue_front(a)
            port_s.requeue_front(b)
            queued[a.uid] = (a, b)
        elif op == "remove" and queued:
            uid = list(queued)[int(rng.integers(0, len(queued)))]
            a, b = queued[uid]
            assert jax_s.remove(a) == port_s.remove(b)
            del queued[uid]
        assert [r.uid for r in jax_s] == [r.uid for r in port_s], f"step {step}: order"
        assert jax_s.snapshot() == port_s.snapshot(), f"step {step}: snapshot"
        assert len(jax_s) == len(port_s)
    assert next_uid > 100 and n_pops > 100
