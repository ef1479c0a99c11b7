"""The port under chaos: every injected failure mode recovers bit-exactly.

``tests/test_chaos.py``'s fast schedules re-pointed at the port: whatever the
:class:`~repro_torch.serve.faults.FaultInjector` throws -- tick exceptions,
poisoned carries, a fully condemned lane pool, slow ticks, torn journal
appends, torn checkpoint writes, simulated process death -- the
:class:`~repro_torch.serve.supervisor.SupervisedEngine` serves every admitted
request to a result equal to a serial ``run_int`` of its raster, loses
nothing, and double-serves nothing the journal knows was completed;
conservation is checked at every poll.  Beside them: ``from_seed`` gives
JAX's schedule, the injector's sites fire at the same arrivals in both
packages, and the port's validity sweep condemns the slot JAX's does.
"""

import asyncio
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.serve import faults as jfaults
from repro.serve import snn_engine as jeng
from repro_torch.checkpoint.checkpointer import latest_step
from repro_torch.core.network import (
    NetworkConfig,
    float_params_from_numpy,
    quantize_params,
    run_int,
)
from repro_torch.core import snn_layer as tsl
from repro_torch.serve.faults import SITES, FaultInjector, SimulatedKill
from repro_torch.serve.http import SNNHttpServer
from repro_torch.serve.snn_engine import AsyncSNNServer, SNNRequest, SNNServeEngine
from repro_torch.serve.streaming import StreamConfig, StreamSessionManager
from repro_torch.serve.supervisor import SupervisedEngine


def _layers(sl):
    return (
        sl.LayerConfig(n_in=16, n_out=10, neuron=sl.NeuronModel.LIF, beta=0.9),
        sl.LayerConfig(n_in=10, n_out=4, neuron=sl.NeuronModel.LIF, beta=0.77),
    )


NET = NetworkConfig(layers=_layers(tsl), n_steps=8)


def _qparams():
    rng = np.random.default_rng(0)
    arrays = [
        (rng.uniform(-0.25, 0.25, (c.n_in, c.n_out)).astype(np.float32), np.zeros(0, np.float32),
         np.float32(c.threshold))
        for c in NET.layers
    ]
    return quantize_params(NET, float_params_from_numpy(NET, arrays, device="cpu"))[0]


QPARAMS = _qparams()
T = 8


def _raster(seed, T_=T, rate=0.4):
    rng = np.random.default_rng(seed)
    return (rng.random((T_, NET.n_in)) < rate).astype(np.uint8)


def _serial(raster):
    x = torch.from_numpy(raster[:, None, :].astype(np.int32))
    return run_int(NET, QPARAMS, x).spike_counts[0].numpy()


def _factory(max_batch=3, **kw):
    # tick_stride=2 keeps requests on lanes across several ticks, so
    # mid-window faults actually catch lanes mid-flight
    kw.setdefault("tick_stride", 2)
    return lambda: SNNServeEngine(NET, QPARAMS, max_batch=max_batch, device="cpu", **kw)


def _submit_all(sup, n, seed0=0):
    rasters = {i: _raster(seed0 + i) for i in range(n)}
    for i, r in rasters.items():
        sup.submit(SNNRequest(uid=i, raster=r))
    return rasters


def _drain_conserving(sup, all_uids, max_polls=10_000):
    """Drain under supervision, asserting conservation at every poll:
    completed and engine-resident uids are disjoint, and together they
    always cover every admitted request (nothing is ever *lost*)."""
    completed = {}
    for _ in range(max_polls):
        if not sup.in_flight:
            break
        for req in sup.poll():
            assert req.uid not in completed, f"uid {req.uid} double-served"
            completed[req.uid] = req
        eng = sup.engine
        resident = {lane.req.uid for lane in eng._lanes if lane is not None}
        resident |= {r.uid for r in eng.sched}
        assert not (set(completed) & resident)
        assert set(completed) | resident == set(all_uids)
    assert sorted(completed) == sorted(all_uids)
    return completed


def _assert_bit_exact(completed, rasters):
    for uid, req in completed.items():
        assert req.status == "completed"
        np.testing.assert_array_equal(req.spike_counts, _serial(rasters[uid]))


# ------------------------------------------------------------ tick failures
def test_tick_exception_is_retried_and_results_stay_bit_exact():
    inj = FaultInjector().arm("tick", at=1)
    sup = SupervisedEngine(_factory(), faults=inj)
    rasters = _submit_all(sup, 6)
    _assert_bit_exact(_drain_conserving(sup, rasters), rasters)
    assert inj.counts["tick"] > 2  # the fault actually fired mid-service
    assert sup.metrics.counters["tick_retries"] == 1
    assert sup.metrics.counters["recoveries_warm"] == 0  # retry was enough


def test_persistent_tick_failures_escalate_to_warm_restart():
    inj = FaultInjector()
    for k in range(1, 6):  # 5 consecutive failing ticks > max_tick_retries
        inj.arm("tick", at=k)
    sup = SupervisedEngine(_factory(), faults=inj, max_tick_retries=2, backoff_s=1e-4)
    first = sup.engine
    rasters = _submit_all(sup, 6)
    _assert_bit_exact(_drain_conserving(sup, rasters), rasters)
    assert sup.metrics.counters["recoveries_warm"] >= 1
    assert sup.status()["last_recovery"]["kind"] == "warm"
    # the restart built a fresh pool and released the dead engine's
    assert sup.engine is not first and first._pools is None


def test_slow_tick_stall_is_counted_without_any_failure():
    inj = FaultInjector().arm("slow_tick", at=0, sleep_s=0.03)
    sup = SupervisedEngine(_factory(), faults=inj, slow_tick_s=0.01)
    rasters = _submit_all(sup, 3)
    _assert_bit_exact(_drain_conserving(sup, rasters), rasters)
    assert sup.metrics.counters["slow_ticks"] >= 1
    assert sup.metrics.counters["recoveries_warm"] == 0
    assert sup.metrics.counters["recoveries_cold"] == 0


# -------------------------------------------------------------- quarantine
def test_poisoned_carry_is_quarantined_and_request_restarts_bit_exact():
    inj = FaultInjector().arm("carry", at=1, bit=26)
    sup = SupervisedEngine(_factory(max_batch=3), faults=inj)
    rasters = _submit_all(sup, 6)
    completed = _drain_conserving(sup, rasters)
    _assert_bit_exact(completed, rasters)
    assert sup.metrics.counters["quarantined_lanes"] == 1
    assert sup.metrics.counters["quarantine_restarts"] == 1
    assert any(req.restarts >= 1 for req in completed.values())
    # the slot stays condemned for the engine's lifetime
    assert sup.engine.capacity == 2 and len(sup.engine.quarantined) == 1


def test_fully_condemned_pool_escalates_to_warm_restart():
    inj = FaultInjector()
    for k, lane in [(1, 0), (2, 1)]:  # poison both lanes of a 2-lane pool
        inj.arm("carry", at=k, lane=lane, bit=26)
    sup = SupervisedEngine(_factory(max_batch=2), faults=inj)
    rasters = _submit_all(sup, 4)
    _assert_bit_exact(_drain_conserving(sup, rasters), rasters)
    assert sup.metrics.counters["quarantined_lanes"] == 2
    assert sup.metrics.counters["recoveries_warm"] >= 1
    assert sup.engine.capacity == 2  # the restart reclaimed the pool


# ------------------------------------------------------------- cold restart
def test_kill_mid_service_cold_restarts_from_journal_bit_exact(tmp_path):
    inj = FaultInjector().arm("kill", at=1)
    sup = SupervisedEngine(_factory(), faults=inj, journal_dir=tmp_path / "wal",
                           journal_fsync_every=1)
    rasters = _submit_all(sup, 6)
    _assert_bit_exact(_drain_conserving(sup, rasters), rasters)
    assert sup.metrics.counters["recoveries_cold"] == 1
    last = sup.status()["last_recovery"]
    assert last["kind"] == "cold" and last["requests_resubmitted"] >= 1
    assert sup.metrics.counters["journal_records_replayed"] >= 6
    sup.close()


def test_torn_journal_append_kills_then_replay_repairs(tmp_path):
    # the 7th journal append (the first *done* record of 6 submits) tears
    # halfway and the process dies; the reopened journal truncates the torn
    # frame, and the victim request re-serves (at-least-once, never lost)
    inj = FaultInjector().arm("journal", at=6)
    sup = SupervisedEngine(_factory(), faults=inj, journal_dir=tmp_path / "wal",
                           journal_fsync_every=1)
    rasters = _submit_all(sup, 6)
    completed, n_results = {}, 0
    while sup.in_flight:
        for req in sup.poll():
            n_results += 1
            completed[req.uid] = req
    _assert_bit_exact(completed, rasters)
    assert sorted(completed) == sorted(rasters)  # nothing lost
    assert n_results <= len(rasters) + 1  # at most the torn victim repeats
    assert sup.metrics.counters["recoveries_cold"] == 1
    sup.close()


# --------------------------------------------------------- torn checkpoints
def test_torn_checkpoint_write_is_invisible_to_readers(tmp_path):
    """A kill between the commit's file writes leaves only an unpublished
    ``.tmp`` husk: ``LATEST`` and every published step stay whole."""
    inj = FaultInjector().arm("checkpoint", at=1)  # second save tears
    engine = SNNServeEngine(NET, QPARAMS, max_batch=2, tick_stride=2, faults=inj, device="cpu")
    ckpt = tmp_path / "ckpt"
    manager = StreamSessionManager(engine, checkpoint_dir=ckpt,
                                   config=StreamConfig(window=4, stride=4))
    stream = _raster(99, T_=16)
    manager.open("s")
    manager.feed("s", stream[:8])
    manager.pump()
    manager.evict("s")  # first save: whole
    manager.feed("s", stream[8:])  # restores, continues
    manager.pump()
    with pytest.raises(SimulatedKill):
        manager.evict("s")  # second save: killed between file writes
    root = ckpt / "s"
    assert latest_step(root) == 8  # the torn step_16 was never published
    assert (root / "step_00000008" / "manifest.json").exists()
    assert not (root / "step_00000016").exists()
    assert (root / "step_00000016.tmp").exists()  # the husk, unpublished


# ------------------------------------------------------- streaming recovery
def test_streaming_kill_recovery_resumes_from_checkpoint_bit_exact(tmp_path):
    """Kill a mid-stream engine after an evict/restore cycle: recovery
    restores the checkpointed carry, re-feeds only the journaled suffix, and
    emits readouts equal to the prefix-count oracle."""
    window, stride, total = 8, 4, 32
    stream = _raster(7, T_=total)

    def oracle(a, b):
        hi = _serial(stream[:b]).astype(np.int64)
        return hi if a == 0 else hi - _serial(stream[:a]).astype(np.int64)

    ckpt = tmp_path / "ckpt"
    inj = FaultInjector().arm("kill", at=9)
    sup = SupervisedEngine(
        _factory(max_batch=2),
        journal_dir=tmp_path / "wal",
        checkpoint_dir=ckpt,
        manager_factory=lambda eng: StreamSessionManager(
            eng, checkpoint_dir=ckpt, config=StreamConfig(window=window, stride=stride)
        ),
        faults=inj,
        journal_fsync_every=1,
    )
    sup.manager.open("s")
    readouts = []

    def drive_until_drained():
        while sup.in_flight:
            sup.poll()
            readouts.extend(sup.manager.drain_readouts("s"))

    for lo in range(0, 16, 8):
        sup.manager.feed("s", stream[lo:lo + 8])
        drive_until_drained()
    sup.manager.evict("s")  # checkpoint at t_total=16
    for lo in range(16, total, 8):
        sup.manager.feed("s", stream[lo:lo + 8])  # restore + kill + recover
        drive_until_drained()
    readouts.extend(sup.manager.drain_readouts("s"))

    assert sup.metrics.counters["recoveries_cold"] == 1
    by_t = {}
    for r in readouts:
        if r.t_end in by_t:  # re-delivered after recovery: identical
            np.testing.assert_array_equal(r.spike_counts, by_t[r.t_end])
        by_t[r.t_end] = r.spike_counts
    assert set(by_t) == set(range(stride, total + 1, stride))
    for t_end, counts in by_t.items():
        np.testing.assert_array_equal(counts, oracle(max(0, t_end - window), t_end))
    sup.close()


# ------------------------------------------------------------------ healthz
def test_healthz_answers_503_with_retry_after_while_recovering():
    async def main():
        engine = SNNServeEngine(NET, QPARAMS, max_batch=2, device="cpu")
        sup = SupervisedEngine(lambda: engine)
        srv = await SNNHttpServer(AsyncSNNServer(engine), supervisor=sup).start()

        async def get_healthz():
            reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
            writer.write(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
            await writer.drain()
            data = await reader.read()
            writer.close()
            await writer.wait_closed()
            head, _, body = data.partition(b"\r\n\r\n")
            headers = head.decode().split("\r\n")
            return int(headers[0].split()[1]), headers[1:], json.loads(body)

        status, _, health = await get_healthz()
        assert status == 200 and health["status"] == "ok"
        assert health["recovery"]["recoveries_cold"] == 0

        sup.recovering = True  # what a cold restart sets while replaying
        sup.retry_after_s = 2.7
        status, headers, health = await get_healthz()
        assert status == 503 and health["status"] == "recovering"
        assert "Retry-After: 2" in headers

        sup.recovering = False
        status, _, health = await get_healthz()
        assert status == 200 and health["status"] == "ok"
        await srv.stop()

    asyncio.run(main())


# ------------------------------------------------------------ cross-package
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_from_seed_schedule_equals_jax(seed):
    kw = dict(n_faults=6, horizon=40, sites=("tick", "carry", "kill", "slow_tick"))
    mine = FaultInjector.from_seed(seed, **kw)
    theirs = jfaults.FaultInjector.from_seed(seed, **kw)
    assert SITES == jfaults.SITES
    assert [(s.site, s.at, s.lane, s.bit, s.every) for s in mine.specs] == [
        (s.site, s.at, s.lane, s.bit, s.every) for s in theirs.specs
    ]


def test_sites_fire_at_the_same_arrivals_as_jax():
    """Drive both injectors' hooks through the same arrival sequence: the
    same faults fire at the same arrival indices, raising the same kinds."""
    mine = FaultInjector.from_seed(3, n_faults=8, horizon=12, sites=("tick", "kill", "journal"))
    theirs = jfaults.FaultInjector.from_seed(3, n_faults=8, horizon=12,
                                             sites=("tick", "kill", "journal"))
    outcomes = []
    for inj, kill, fault in ((mine, SimulatedKill, Exception),
                             (theirs, jfaults.SimulatedKill, Exception)):
        seen = []
        for _ in range(14):
            try:
                inj.on_tick()
                seen.append("ok")
            except kill:
                seen.append("kill")
            except fault:
                seen.append("raise")
            seen.append(inj.torn_journal_bytes(b"0123456789"))
        outcomes.append((seen, [(site, n) for site, n, _ in inj.fired]))
    assert outcomes[0] == outcomes[1]


def test_poison_and_sweep_condemn_the_slot_jax_condemns():
    """One tick of the same requests in both engines, the same carry fault:
    both sweeps return the same slot, the poisoned carries are equal, and
    quarantine requeues the same request."""
    rng = np.random.default_rng(5)
    rasters = [(rng.random((6, 16)) < 0.4).astype(np.uint8) for _ in range(3)]
    jn = jnet.NetworkConfig(layers=_layers(jsl), n_steps=8)
    jq = [jsl.IntLayerParams(*(jnp.asarray(a.numpy()) for a in p)) for p in QPARAMS]
    te = SNNServeEngine(NET, QPARAMS, max_batch=4, tick_stride=2, device="cpu",
                        faults=FaultInjector().arm("carry", at=0, lane=2))
    je = jeng.SNNServeEngine(jn, jq, max_batch=4, tick_stride=2,
                             faults=jfaults.FaultInjector().arm("carry", at=0, lane=2))
    for e, mk in ((te, SNNRequest), (je, jeng.SNNRequest)):
        for i, r in enumerate(rasters):
            e.submit(mk(uid=i, raster=r))
        e.poll()
        assert e.sweep_carries() == [2]
    for a, b in zip(te._pools[0], je._states):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert te.quarantine_lane(2).uid == je.quarantine_lane(2).uid == 2
    assert (te.capacity, te.free_lanes, sorted(te.quarantined)) == (
        je.capacity, je.free_lanes, sorted(je.quarantined))
