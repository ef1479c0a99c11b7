"""The port's HTTP front end: the client-side failure modes, contained.

``tests/test_serve_http.py`` and ``tests/test_streaming_http.py`` re-pointed
at ``repro_torch.serve.http`` over the port's engine on the CPU.  All tests
drive the real server over real sockets (``asyncio.start_server`` /
``asyncio.open_connection``) inside ``asyncio.run``.  The request routes: a
vanishing stream reader, a cancelled future, a raising completion callback
and malformed requests all leave the engine serving; a wedged engine fails
every pending future and flips ``/healthz`` to "stalled".  The session
routes: a client that vanishes mid-feed loses only its response,
double-close / feed-after-close / unknown sessions / a full buffer answer
409 / 404 / 429, a wedged engine fails a feed instead of hanging it, and a
corrupted checkpoint is refused with a clear 500.  A readout over HTTP
equals the serial ``run_int`` prefix counts of the stream.
"""

import asyncio
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.network import (
    NetworkConfig,
    float_params_from_numpy,
    quantize_params,
    run_int,
)
from repro_torch.core.snn_layer import LayerConfig, NeuronModel, ResetMode, Topology
from repro_torch.serve.http import SNNHttpServer, parse_request_json
from repro_torch.serve.scheduler import Priority, Scheduler
from repro_torch.serve.snn_engine import (
    AsyncSNNServer,
    EngineStalledError,
    SNNRequest,
    SNNServeEngine,
)
from repro_torch.serve.streaming import AsyncStreamServer, StreamConfig, StreamSessionManager

NET = NetworkConfig(
    layers=(
        LayerConfig(n_in=16, n_out=10, neuron=NeuronModel.LIF, topology=Topology.FF,
                    reset=ResetMode.SUBTRACT, beta=0.9),
        LayerConfig(n_in=10, n_out=4, neuron=NeuronModel.LIF,
                    reset=ResetMode.ZERO, beta=0.77),
    ),
    n_steps=8,
)


def _qparams():
    rng = np.random.default_rng(0)
    arrays = [
        (rng.uniform(-0.25, 0.25, (c.n_in, c.n_out)).astype(np.float32), np.zeros(0, np.float32),
         np.float32(c.threshold))
        for c in NET.layers
    ]
    return quantize_params(NET, float_params_from_numpy(NET, arrays, device="cpu"))[0]


QPARAMS = _qparams()


def _engine(**kw):
    kw.setdefault("max_batch", 2)
    return SNNServeEngine(NET, QPARAMS, device="cpu", **kw)


def _raster(T=8, seed=0, rate=0.4):
    rng = np.random.default_rng(seed)
    return (rng.random((T, NET.n_in)) < rate).astype(np.int32)


def _serial(raster):
    x = torch.from_numpy(np.asarray(raster, np.int32)[:, None, :])
    return run_int(NET, QPARAMS, x).spike_counts[0].numpy().astype(np.int64)


async def _http(port, method, path, body=None, read_all=True):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload
    )
    await writer.drain()
    if not read_all:
        return reader, writer
    data = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, rest = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


async def _post(port, path, body=None, read_all=True):
    """POST with a JSON answer (the session routes)."""
    out = await _http(port, "POST", path, body, read_all)
    if not read_all:
        return out
    status, rest = out
    return status, json.loads(rest) if rest else {}


def _stack(tmp_path=None, *, tick_s=0.0, engine_kw=None, **cfg):
    """engine + async server + session manager + HTTP facade (unstarted)."""
    engine = _engine(**(engine_kw or {}))
    server = AsyncSNNServer(engine)
    cfg.setdefault("window", 8)
    cfg.setdefault("stride", 4)
    cfg.setdefault("idle_budget", None)
    manager = StreamSessionManager(
        engine,
        checkpoint_dir=None if tmp_path is None else tmp_path / "ck",
        config=StreamConfig(**cfg),
    )
    http = SNNHttpServer(
        server, streaming=AsyncStreamServer(server, manager), stream_tick_s=tick_s
    )
    return engine, server, manager, http


def test_submit_roundtrip_and_reject_statuses():
    async def main():
        srv = await SNNHttpServer(AsyncSNNServer(_engine())).start()
        status, body = await _http(
            srv.port, "POST", "/submit",
            {"raster": _raster().tolist(), "priority": "critical", "uid": 7},
        )
        out = json.loads(body)
        assert status == 200
        assert out["uid"] == 7 and out["status"] == "completed"
        assert out["tier"] == "full" and len(out["spike_counts"]) == 4
        # an unmeetable deadline rejects -> HTTP 429 (early back-pressure)
        status, body = await _http(
            srv.port, "POST", "/submit",
            {"raster": _raster().tolist(), "deadline_s": 1e-9},
        )
        assert status == 429 and json.loads(body)["status"] == "rejected"
        status, body = await _http(srv.port, "GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert health["free_lanes"] == 2 and not health["in_flight"]
        status, body = await _http(srv.port, "GET", "/metrics")
        assert status == 200
        assert 'neura_requests_total{outcome="completed"} 1' in body.decode()
        assert 'neura_requests_total{outcome="rejected"} 1' in body.decode()
        status, body = await _http(srv.port, "GET", "/metrics.json")
        assert status == 200 and json.loads(body)["counters"]["submitted"] == 2
        await srv.stop()

    asyncio.run(main())


def test_stream_serves_all_as_ndjson():
    async def main():
        srv = await SNNHttpServer(AsyncSNNServer(_engine())).start()
        n = 5
        status, body = await _http(
            srv.port, "POST", "/stream",
            {"requests": [{"raster": _raster(seed=i).tolist(), "uid": i}
                          for i in range(n)]},
        )
        assert status == 200
        lines = [json.loads(l) for l in body.splitlines()]
        assert sorted(r["uid"] for r in lines) == list(range(n))
        assert all(r["status"] == "completed" for r in lines)
        await srv.stop()

    asyncio.run(main())


def test_client_disconnect_mid_stream_frees_lanes_and_keeps_serving():
    async def main():
        engine = _engine(tick_stride=1)  # strict per-step ticks: a slow stream
        server = AsyncSNNServer(engine)
        srv = await SNNHttpServer(server).start()
        reader, writer = await _http(
            srv.port, "POST", "/stream",
            {"requests": [{"raster": _raster(T=8, seed=i).tolist(), "uid": i}
                          for i in range(6)]},
            read_all=False,
        )
        await reader.readline()  # status line arrives: the stream is live
        writer.close()  # client vanishes mid-stream
        await writer.wait_closed()
        # the engine must keep serving the submitted work to completion
        for _ in range(2000):
            if not engine.in_flight:
                break
            await asyncio.sleep(0.005)
        assert not engine.in_flight
        assert engine.free_lanes == engine.max_batch
        assert engine.n_served == 6
        assert engine.metrics.counters["http_disconnects"] >= 1
        # and the front line still answers
        status, body = await _http(srv.port, "GET", "/healthz")
        assert status == 200 and json.loads(body)["served"] == 6
        await srv.stop()

    asyncio.run(main())


def test_future_cancellation_leaves_engine_clean():
    async def main():
        engine = _engine(tick_stride=1)
        server = AsyncSNNServer(engine)
        reqs = [SNNRequest(uid=i, raster=_raster(seed=i)) for i in range(3)]
        futs = [server.submit(r) for r in reqs]
        futs[1].cancel()
        done = await asyncio.gather(*[futs[0], futs[2]])
        assert [r.uid for r in done] == [0, 2]
        with pytest.raises(asyncio.CancelledError):
            futs[1].result()
        # the cancelled request still served (work is never torn out of the
        # engine mid-lane); only its resolution was dropped
        for _ in range(2000):
            if not engine.in_flight:
                break
            await asyncio.sleep(0.005)
        assert reqs[1].status == "completed"
        assert engine.free_lanes == engine.max_batch
        assert not server._futures  # no leaked future entries

    asyncio.run(main())


def test_raising_callback_never_breaks_the_drive_loop():
    async def main():
        engine = _engine()
        server = AsyncSNNServer(engine)

        def boom(req):
            raise RuntimeError("client callback bug")

        reqs = [SNNRequest(uid=i, raster=_raster(seed=i), on_complete=boom)
                for i in range(4)]
        done = await server.serve(reqs)
        assert sorted(r.uid for r in done) == [0, 1, 2, 3]
        assert all(r.status == "completed" for r in done)
        assert engine.metrics.counters["callback_failures"] == 4
        assert engine.free_lanes == engine.max_batch

    asyncio.run(main())


def test_engine_stall_fails_pending_futures_and_flips_healthz():
    async def main():
        engine = _engine(max_batch=1, max_idle_ticks=3)

        class Wedged(Scheduler):
            def pop(self):
                return None

        engine.sched = Wedged()
        server = AsyncSNNServer(engine)
        srv = await SNNHttpServer(server).start()
        fut = server.submit(SNNRequest(uid=0, raster=_raster()))
        with pytest.raises(EngineStalledError) as exc:
            await fut
        assert exc.value.queue_snapshot["depth"] == 1
        assert isinstance(server.error, EngineStalledError)
        status, body = await _http(srv.port, "GET", "/healthz")
        assert status == 200 and json.loads(body)["status"] == "stalled"
        await srv.stop()

    asyncio.run(main())


def test_malformed_requests_answer_4xx_and_server_survives():
    async def main():
        srv = await SNNHttpServer(AsyncSNNServer(_engine())).start()
        status, body = await _http(srv.port, "POST", "/submit", None)  # empty body
        assert status == 400
        status, body = await _http(srv.port, "POST", "/submit", {"raster": [1, 2, 3]})
        assert status == 400 and "raster" in json.loads(body)["error"]
        status, body = await _http(
            srv.port, "POST", "/submit",
            {"raster": _raster().tolist(), "priority": "turbo"},
        )
        assert status == 400 and "priority" in json.loads(body)["error"]
        status, body = await _http(srv.port, "POST", "/submit", {"uid": 1})
        assert status == 400 and "missing 'raster'" in json.loads(body)["error"]
        status, body = await _http(srv.port, "POST", "/stream", {"requests": []})
        assert status == 400
        status, _ = await _http(srv.port, "GET", "/nope")
        assert status == 404
        # after all that abuse, a clean request still serves
        status, body = await _http(
            srv.port, "POST", "/submit", {"raster": _raster().tolist()}
        )
        assert status == 200 and json.loads(body)["status"] == "completed"
        await srv.stop()

    asyncio.run(main())


def test_parse_request_json_contract():
    req = parse_request_json(
        {"raster": _raster().tolist(), "priority": "best-effort",
         "tenant": "t1", "deadline_s": 2.5},
        uid=42,
    )
    assert req.uid == 42 and req.priority is Priority.BEST_EFFORT
    assert req.tenant == "t1" and req.deadline_s == 2.5
    assert parse_request_json({"raster": _raster().tolist(), "priority": 0}, 1
                              ).priority is Priority.CRITICAL
    with pytest.raises(ValueError, match="JSON object"):
        parse_request_json([1, 2], 1)


# ---------------------------------------------------------------- sessions


def test_session_roundtrip_readouts_and_subscription():
    async def main():
        _, _, manager, http = _stack()
        await http.start()
        p = http.port
        status, s = await _post(p, "/session/open", {"sid": "x", "window": 8,
                                                     "stride": 4})
        assert status == 200 and s["session"] == "x" and s["state"] == "live"

        # long-lived NDJSON subscription on its own connection
        reader, writer = await _post(p, "/session/stream", {"session": "x"},
                                     read_all=False)
        assert b"200" in await reader.readline()
        while (await reader.readline()) not in (b"\r\n", b"\n"):
            pass

        status, out = await _post(
            p, "/session/feed", {"session": "x", "chunk": _raster(10).tolist()}
        )
        assert status == 200 and out["t_total"] == 10
        assert [r["t_end"] for r in out["readouts"]] == [4, 8]
        for r in out["readouts"]:
            assert len(r["spike_counts"]) == NET.n_classes
            assert r["prediction"] == int(np.argmax(r["spike_counts"]))
            # window [0, t_end): the serial run's prefix counts
            assert r["spike_counts"] == _serial(_raster(10)[: r["t_end"]]).tolist()

        # the subscriber saw the same readouts, in order
        lines = [json.loads(await reader.readline()) for _ in range(2)]
        assert [l["t_end"] for l in lines] == [4, 8]

        status, summary = await _post(p, "/session/close", {"session": "x"})
        assert status == 200 and summary["state"] == "closed"
        assert summary["t_total"] == 10 and summary["chunks"] >= 1
        final = json.loads(await reader.readline())
        assert final["state"] == "closed"  # end-of-stream summary line
        assert await reader.readline() == b""  # then the stream closes
        writer.close()
        await http.stop()

    asyncio.run(main())


def test_mid_feed_disconnect_leaves_session_resumable():
    async def main():
        engine, _, manager, http = _stack(engine_kw={"tick_stride": 1})
        await http.start()
        p = http.port
        await _post(p, "/session/open", {"sid": "x"})
        # fire a feed and vanish before the response arrives
        reader, writer = await _post(
            p, "/session/feed", {"session": "x", "chunk": _raster(12).tolist()},
            read_all=False,
        )
        writer.close()
        await writer.wait_closed()
        # the chunk still serves to completion: carry lands, readouts queue
        for _ in range(2000):
            s = manager.sessions["x"]
            if s.drained and s.t_total == 12:
                break
            await asyncio.sleep(0.005)
        assert manager.sessions["x"].t_total == 12
        assert manager.sessions["x"].carry is not None
        assert engine.free_lanes == engine.max_batch
        # the disconnected feed's readouts were produced (delivered to any
        # /session/stream subscriber); only the dead response lost its copy
        assert manager.sessions["x"].n_readouts == 3  # t_end 4, 8, 12
        # and the session keeps serving from a fresh connection, carry intact
        status, out = await _post(
            p, "/session/feed", {"session": "x", "chunk": _raster(4, seed=1).tolist()}
        )
        assert status == 200 and out["t_total"] == 16
        assert [r["t_end"] for r in out["readouts"]] == [16]
        await http.stop()

    asyncio.run(main())


def test_double_close_and_feed_after_close_are_clean_4xx():
    async def main():
        _, _, _, http = _stack()
        await http.start()
        p = http.port
        await _post(p, "/session/open", {"sid": "x"})
        status, _ = await _post(p, "/session/close", {"session": "x"})
        assert status == 200
        status, err = await _post(p, "/session/close", {"session": "x"})
        assert status == 409 and "closed" in err["error"]
        status, err = await _post(
            p, "/session/feed", {"session": "x", "chunk": _raster(2).tolist()}
        )
        assert status == 409 and "closed" in err["error"]
        status, err = await _post(
            p, "/session/feed", {"session": "ghost", "chunk": _raster(2).tolist()}
        )
        assert status == 404 and "unknown session" in err["error"]
        status, err = await _post(p, "/session/close", {"session": "ghost"})
        assert status == 404
        # malformed session bodies are 400s, and the server survives them
        await _post(p, "/session/open", {"sid": "y"})
        status, err = await _post(p, "/session/feed", {"session": "y"})
        assert status == 400 and "chunk" in err["error"]
        status, err = await _post(
            p, "/session/feed", {"session": "y", "chunk": [[1, 2], [3, 4]]}
        )
        assert status == 400  # wrong channel count
        status, err = await _post(p, "/session/open", {"sid": "y"})
        assert status == 400 and "already exists" in err["error"]
        # back-pressure: a chunk that would overflow the buffer answers 429
        await _post(p, "/session/open", {"sid": "z", "max_pending_steps": 4})
        status, err = await _post(
            p, "/session/feed", {"session": "z", "chunk": _raster(8).tolist()}
        )
        assert status == 429 and "pending buffer full" in err["error"]
        # nothing was partially absorbed by the refused feed
        status, out = await _post(
            p, "/session/feed", {"session": "z", "chunk": _raster(4).tolist()}
        )
        assert status == 200 and out["t_total"] == 4
        await http.stop()

    asyncio.run(main())


def test_engine_stall_fails_feed_with_stalled_error():
    async def main():
        engine, server, manager, http = _stack(
            engine_kw={"max_batch": 1, "max_idle_ticks": 3}
        )

        class Wedged(Scheduler):
            def pop(self):
                return None

        engine.sched = Wedged()
        await http.start()
        p = http.port
        await _post(p, "/session/open", {"sid": "x"})
        status, err = await _post(
            p, "/session/feed", {"session": "x", "chunk": _raster(6).tolist()}
        )
        assert status == 500 and "stalled" in err["error"].lower()
        assert isinstance(server.error, EngineStalledError)
        await http.stop()

    asyncio.run(main())


def test_corrupted_checkpoint_rejected_with_clear_error(tmp_path):
    async def main():
        _, _, manager, http = _stack(tmp_path)
        await http.start()
        p = http.port
        await _post(p, "/session/open", {"sid": "x"})
        status, _ = await _post(
            p, "/session/feed", {"session": "x", "chunk": _raster(9).tolist()}
        )
        assert status == 200
        manager.evict("x")
        assert manager.sessions["x"].state == "evicted"

        # flip bytes in the on-disk carry: the CRC gate must refuse it
        npz = next(pathlib.Path(tmp_path / "ck" / "x").glob("step_*/arrays.npz"))
        blob = bytearray(npz.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        npz.write_bytes(bytes(blob))

        status, err = await _post(
            p, "/session/feed", {"session": "x", "chunk": _raster(3).tolist()}
        )
        assert status == 500
        assert "x" in err["error"] and "restore" in err["error"]
        # the session was not half-restored into garbage state
        assert manager.sessions["x"].state == "evicted"
        assert manager.sessions["x"].carry is None
        await http.stop()

    asyncio.run(main())


def test_idle_ticker_evicts_and_feed_restores(tmp_path):
    async def main():
        _, _, manager, http = _stack(tmp_path, tick_s=0.01, idle_budget=2)
        await http.start()
        p = http.port
        await _post(p, "/session/open", {"sid": "x"})
        status, out = await _post(
            p, "/session/feed", {"session": "x", "chunk": _raster(9).tolist()}
        )
        assert status == 200
        for _ in range(500):
            if manager.sessions["x"].state == "evicted":
                break
            await asyncio.sleep(0.01)
        assert manager.sessions["x"].state == "evicted"
        assert manager.metrics.counters["sessions_evicted"] == 1
        # the next feed restores bit-exactly and keeps counting readouts
        status, out = await _post(
            p, "/session/feed", {"session": "x", "chunk": _raster(3, seed=2).tolist()}
        )
        assert status == 200 and out["state"] == "live"
        assert out["t_total"] == 12 and [r["t_end"] for r in out["readouts"]] == [12]
        assert manager.sessions["x"].n_restores == 1
        snap = manager.metrics.snapshot()
        assert snap["streaming"]["resumes"] == 1
        assert snap["streaming"]["live_sessions"] == 1
        await http.stop()

    asyncio.run(main())


def test_session_routes_404_when_streaming_disabled():
    async def main():
        engine = _engine()
        http = SNNHttpServer(AsyncSNNServer(engine))  # no streaming facade
        await http.start()
        status, err = await _post(http.port, "/session/open", {"sid": "x"})
        assert status == 404 and "not enabled" in err["error"]
        await http.stop()

    asyncio.run(main())


def test_prometheus_exposes_stream_series():
    async def main():
        _, _, manager, http = _stack()
        await http.start()
        manager.open("x")
        text = manager.metrics.prometheus_text()
        assert 'neura_stream_sessions{state="live"} 1' in text
        assert 'neura_stream_events_total{event="sessions_opened"} 1' in text
        assert "neura_stream_readout_latency_seconds" in text
        await http.stop()

    asyncio.run(main())


def test_feed_shape_validation():
    engine = _engine()
    manager = StreamSessionManager(engine)
    manager.open("x")
    with pytest.raises(ValueError, match="steps"):
        manager.feed("x", np.zeros((3, NET.n_in + 1), np.int64))
    with pytest.raises(ValueError, match="empty"):
        manager.feed("x", np.zeros((0, NET.n_in), np.int64))
