"""Minimal asyncio HTTP + streaming front-end over :class:`AsyncSNNServer`.

Port of ``repro/serve/http.py``: pure asyncio and host Python, unchanged;
it serves the port's engine, whatever device that engine runs on.

Dependency-free by design (the container carries no web framework): a
hand-rolled HTTP/1.1 request parser over ``asyncio.start_server``, one
connection per request, ``Connection: close`` semantics throughout.  Four
endpoints:

``POST /submit``
    Body: one JSON request object (see :func:`parse_request_json`).
    Blocks until the request reaches a terminal state and answers with the
    result JSON -- ``200`` for completed/degraded, ``429`` for a rejected
    request (the deadline policy's early reject *is* back-pressure).
``POST /stream``
    Body: ``{"requests": [...]}``.  Streams one NDJSON result line per
    request *as each completes* (completion order, not submit order) and
    closes.  A client that disconnects mid-stream increments the
    ``http_disconnects`` counter; the engine keeps serving -- submitted
    work is never cancelled by a vanishing reader.
``GET /metrics``
    The engine's rolling metrics in Prometheus exposition format
    (``repro_torch.serve.metrics.ServeMetrics.prometheus_text``);
    ``GET /metrics.json`` returns the raw ``snapshot()`` dict.
``GET /healthz``
    Liveness + queue/lane gauges as JSON.

Streaming sessions (when the server is built with an
:class:`~repro_torch.serve.streaming.AsyncStreamServer`):

``POST /session/open``
    Body: ``{"sid"?: str, "window"?, "stride"?, "idle_budget"?,
    "tenant"?}`` (omitted knobs take the manager's defaults).  Answers the
    new session's summary; ``sid`` collisions are a ``400``.
``POST /session/feed``
    Body: ``{"session": sid, "chunk": [[...step...], ...]}``.  Appends the
    raster steps to the stream (restoring an evicted session first),
    drives the session until the chunk is fully absorbed, and answers with
    the readouts this feed produced.  Unknown session: ``404``; closed:
    ``409``; pending-buffer overflow: ``429`` (back-pressure -- nothing
    was accepted); unrestorable checkpoint: ``500`` with the corruption
    message.  A client that disconnects mid-feed loses only the response:
    the chunk still serves and the session stays resumable.
``POST /session/stream``
    Body: ``{"session": sid}``.  Long-lived NDJSON subscription: one line
    per readout as the stream produces them (from *any* connection's
    feeds), a final summary line at session close.
``POST /session/close``
    Body: ``{"session": sid}``.  Finalises the session, answers its
    lifetime summary.  Double-close is a ``409``.

Malformed JSON or a bad raster answers ``400`` with the error message;
anything else that escapes a handler answers ``500`` (and the serving loop
survives -- fault-injection tests drive all three).

The server binds ``host:port`` at :meth:`SNNHttpServer.start` (port 0
picks a free port, reported back via ``server.port``) and is fully
in-process: tests drive it over real sockets with ``asyncio.open_connection``.
"""

from __future__ import annotations

import asyncio
import itertools
import json

import numpy as np

from repro_torch.serve.scheduler import Priority
from repro_torch.serve.snn_engine import AsyncSNNServer, SNNRequest
from repro_torch.serve.streaming import (
    AsyncStreamServer,
    SessionClosedError,
    StreamError,
    StreamOverflowError,
    UnknownSessionError,
)

__all__ = ["SNNHttpServer", "parse_request_json", "result_json"]


def parse_request_json(obj: dict, uid: int) -> SNNRequest:
    """Build an :class:`SNNRequest` from one JSON request object.

    Fields: ``raster`` (required, [T][n_in] ints), ``uid`` (default: server
    assigned), ``priority`` (class name, case-insensitive, or int value),
    ``tenant``, ``deadline_s``.
    """
    if not isinstance(obj, dict):
        raise ValueError(f"request must be a JSON object, got {type(obj).__name__}")
    if "raster" not in obj:
        raise ValueError("request is missing 'raster'")
    prio = obj.get("priority", Priority.STANDARD)
    if isinstance(prio, str):
        try:
            prio = Priority[prio.upper().replace("-", "_")]
        except KeyError:
            raise ValueError(
                f"unknown priority {obj['priority']!r}; expected one of "
                f"{[p.name.lower() for p in Priority]}"
            ) from None
    deadline = obj.get("deadline_s")
    return SNNRequest(
        uid=int(obj.get("uid", uid)),
        raster=np.asarray(obj["raster"], np.int32),
        priority=Priority(prio),
        tenant=str(obj.get("tenant", "default")),
        deadline_s=None if deadline is None else float(deadline),
    )


def result_json(req: SNNRequest) -> dict:
    """Terminal-state request -> the wire-format result object."""
    return {
        "uid": req.uid,
        "status": req.status,
        "prediction": req.prediction,
        "spike_counts": None
        if req.spike_counts is None
        else np.asarray(req.spike_counts).tolist(),
        "route": req.route,
        "tier": req.tier,
        "latency_s": req.latency_s,
        "preemptions": req.preemptions,
    }


class SNNHttpServer:
    """The HTTP front line: routes, parsing, and fault containment.

    Wraps an :class:`AsyncSNNServer` (which wraps the engine); all QoS
    behavior -- priorities, deadlines, preemption, degradation -- lives in
    the engine's control plane, this class only translates HTTP.
    """

    def __init__(
        self,
        server: AsyncSNNServer,
        host: str = "127.0.0.1",
        port: int = 0,
        streaming: AsyncStreamServer | None = None,
        stream_tick_s: float = 0.05,
        supervisor=None,
    ):
        self.server = server
        self.host = host
        self.port = port
        self.streaming = streaming
        self.stream_tick_s = stream_tick_s
        # repro_torch.serve.supervisor.SupervisedEngine, when serving runs under
        # one: /healthz answers 503 + Retry-After while it is recovering,
        # and its status() rides the health payload
        self.supervisor = supervisor
        self._srv: asyncio.base_events.Server | None = None
        self._ticker: asyncio.Task | None = None
        self._uid = itertools.count(1_000_000)  # server-assigned uids

    @property
    def metrics(self):
        return self.server.engine.metrics

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> "SNNHttpServer":
        self._srv = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._srv.sockets[0].getsockname()[1]
        if self.streaming is not None and self.stream_tick_s > 0:
            self._ticker = asyncio.get_running_loop().create_task(self._idle_ticker())
        return self

    async def stop(self) -> None:
        if self._ticker is not None:
            self._ticker.cancel()
            try:
                await self._ticker
            except asyncio.CancelledError:
                pass
            self._ticker = None
        if self._srv is not None:
            self._srv.close()
            await self._srv.wait_closed()
            self._srv = None

    async def _idle_ticker(self) -> None:
        """Housekeeping heartbeat: ages drained sessions toward eviction
        while no feed traffic is flowing."""
        while True:
            await asyncio.sleep(self.stream_tick_s)
            self.streaming.idle_tick()

    async def serve_forever(self) -> None:
        if self._srv is None:
            await self.start()
        async with self._srv:
            await self._srv.serve_forever()

    # -- one connection ------------------------------------------------------
    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            parsed = await self._read_request(reader)
            if parsed is None:
                return
            method, path, body = parsed
            if path == "/healthz" and method == "GET":
                health = self._health()
                if health["status"] == "recovering":
                    # load balancers must stop sending traffic and come
                    # back after the journal replay, not error the pool
                    await self._respond_json(
                        writer,
                        503,
                        health,
                        extra_headers={
                            "Retry-After": str(
                                max(1, int(self.supervisor.retry_after_s))
                            )
                        },
                    )
                else:
                    await self._respond_json(writer, 200, health)
            elif path == "/metrics" and method == "GET":
                await self._respond(
                    writer, 200, self.metrics.prometheus_text().encode(),
                    "text/plain; version=0.0.4",
                )
            elif path == "/metrics.json" and method == "GET":
                await self._respond_json(writer, 200, self.metrics.snapshot())
            elif path == "/submit" and method == "POST":
                await self._submit(writer, body)
            elif path == "/stream" and method == "POST":
                await self._stream(writer, body)
            elif path.startswith("/session/") and method == "POST":
                await self._session(writer, path, body)
            else:
                await self._respond_json(
                    writer, 404, {"error": f"no route for {method} {path}"}
                )
        except UnknownSessionError as e:
            await self._respond_json(writer, 404, {"error": str(e)}, best_effort=True)
        except SessionClosedError as e:
            await self._respond_json(writer, 409, {"error": str(e)}, best_effort=True)
        except StreamOverflowError as e:
            await self._respond_json(writer, 429, {"error": str(e)}, best_effort=True)
        except StreamError as e:  # e.g. an unrestorable (corrupt) checkpoint
            await self._respond_json(writer, 500, {"error": str(e)}, best_effort=True)
        except (ValueError, json.JSONDecodeError) as e:
            await self._respond_json(writer, 400, {"error": str(e)}, best_effort=True)
        except (ConnectionError, asyncio.IncompleteReadError):
            self.metrics.inc("http_disconnects")
        except Exception as e:  # the front line must survive anything
            await self._respond_json(
                writer, 500, {"error": f"{type(e).__name__}: {e}"}, best_effort=True
            )
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line or not line.strip():
            return None
        parts = line.decode("latin1").split()
        if len(parts) < 2:
            raise ValueError(f"malformed request line: {line!r}")
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            key, _, val = h.decode("latin1").partition(":")
            headers[key.strip().lower()] = val.strip()
        n = int(headers.get("content-length", 0) or 0)
        body = await reader.readexactly(n) if n else b""
        return method, path, body

    # -- endpoint bodies -----------------------------------------------------
    def _health(self) -> dict:
        eng = self.server.engine
        status = "ok" if self.server.error is None else "stalled"
        out = {
            "status": status,
            "in_flight": eng.in_flight,
            "active_lanes": eng.active_lanes,
            "free_lanes": eng.free_lanes,
            "queue_depth": len(eng.queue),
            "served": eng.n_served,
        }
        if self.supervisor is not None:
            if self.supervisor.recovering:
                out["status"] = "recovering"
            out["recovery"] = self.supervisor.status()
        return out

    async def _submit(self, writer, body: bytes) -> None:
        req = parse_request_json(json.loads(body.decode()), next(self._uid))
        done = await self.server.submit(req)
        status = 429 if done.status == "rejected" else 200
        await self._respond_json(writer, status, result_json(done))

    async def _stream(self, writer, body: bytes) -> None:
        obj = json.loads(body.decode())
        items = obj.get("requests") if isinstance(obj, dict) else None
        if not isinstance(items, list) or not items:
            raise ValueError("body must be {\"requests\": [...]} with >= 1 entry")
        reqs = [parse_request_json(o, next(self._uid)) for o in items]
        futures = [self.server.submit(r) for r in reqs]
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/x-ndjson\r\n"
            b"Connection: close\r\n\r\n"
        )
        # results stream in completion order; a vanished reader stops the
        # writes but never the work (futures resolve via the drive loop)
        for fut in asyncio.as_completed(futures):
            done = await fut
            try:
                writer.write((json.dumps(result_json(done)) + "\n").encode())
                await writer.drain()
            except (ConnectionError, OSError):
                self.metrics.inc("http_disconnects")
                break

    # -- streaming sessions --------------------------------------------------
    async def _session(self, writer, path: str, body: bytes) -> None:
        if self.streaming is None:
            await self._respond_json(
                writer, 404, {"error": "streaming sessions are not enabled"}
            )
            return
        obj = json.loads(body.decode()) if body else {}
        if not isinstance(obj, dict):
            raise ValueError(f"body must be a JSON object, got {type(obj).__name__}")
        if path == "/session/open":
            overrides = {
                k: obj[k]
                for k in ("window", "stride", "idle_budget", "tenant",
                          "max_pending_steps", "max_chunk_steps")
                if k in obj
            }
            s = self.streaming.open(obj.get("sid"), **overrides)
            await self._respond_json(writer, 200, s.summary())
        elif path == "/session/feed":
            sid = str(obj.get("session", ""))
            if "chunk" not in obj:
                raise ValueError("feed is missing 'chunk'")
            chunk = np.asarray(obj["chunk"], np.int64)
            s, readouts = await self.streaming.feed(sid, chunk)
            await self._respond_json(writer, 200, {
                "session": s.sid,
                "state": s.state,
                "t_total": s.t_total,
                "readouts": [r.to_json() for r in readouts],
            })
        elif path == "/session/stream":
            await self._session_stream(writer, str(obj.get("session", "")))
        elif path == "/session/close":
            summary = self.streaming.close(str(obj.get("session", "")))
            await self._respond_json(writer, 200, summary)
        else:
            await self._respond_json(
                writer, 404, {"error": f"no route for POST {path}"}
            )

    async def _session_stream(self, writer, sid: str) -> None:
        """Long-lived NDJSON readout subscription for one session."""
        mgr = self.streaming.manager
        queue: asyncio.Queue = asyncio.Queue()
        mgr.subscribe(sid, queue.put_nowait)  # raises 404/409 before headers
        session = mgr.sessions[sid]
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/x-ndjson\r\n"
            b"Connection: close\r\n\r\n"
        )
        try:
            while True:
                r = await queue.get()
                line = session.summary() if r is None else r.to_json()
                writer.write((json.dumps(line) + "\n").encode())
                await writer.drain()
                if r is None:  # end-of-stream sentinel from close()
                    break
        except (ConnectionError, OSError):
            self.metrics.inc("http_disconnects")
        finally:  # a vanished subscriber must not leak its listener
            if queue.put_nowait in session._listeners:
                session._listeners.remove(queue.put_nowait)

    # -- response plumbing ---------------------------------------------------
    _REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found", 409: "Conflict",
                429: "Too Many Requests", 500: "Internal Server Error",
                503: "Service Unavailable"}

    async def _respond(
        self,
        writer,
        status: int,
        payload: bytes,
        ctype: str,
        best_effort: bool = False,
        extra_headers: dict | None = None,
    ) -> None:
        try:
            extras = "".join(
                f"{k}: {v}\r\n" for k, v in (extra_headers or {}).items()
            )
            writer.write(
                f"HTTP/1.1 {status} {self._REASONS.get(status, '')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"{extras}"
                f"Connection: close\r\n\r\n".encode() + payload
            )
            await writer.drain()
        except (ConnectionError, OSError):
            if not best_effort:
                raise  # the handler's outer catch counts the disconnect

    async def _respond_json(
        self,
        writer,
        status: int,
        obj: dict,
        best_effort: bool = False,
        extra_headers: dict | None = None,
    ) -> None:
        await self._respond(
            writer,
            status,
            json.dumps(obj).encode(),
            "application/json",
            best_effort,
            extra_headers,
        )
