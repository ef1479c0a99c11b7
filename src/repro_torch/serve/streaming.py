"""Streaming stateful sessions: forever-lanes with carry-exact chunking.

Port of ``repro/serve/streaming.py``: the session manager is host Python
and numpy, unchanged; chunk requests ride the port's
:class:`~repro_torch.serve.snn_engine.SNNServeEngine` lane pool on its
device, carries cross to the host as numpy snapshots, and eviction goes
through the port's :class:`~repro_torch.checkpoint.checkpointer.Checkpointer`
(the same on-disk layout as the JAX package's).

Every other serving path assumes fixed-T samples, but the paper's target
workloads (wearable biosignal / auditory SHD, DVS gesture) are *unbounded
sensor streams*.  This module turns the engine's carry seams
(``int_layer_window_carry`` freezing at the validity boundary,
``lane_state_take``/``lane_state_put``) into a session abstraction: a
:class:`StreamSession` owns a persistent per-stream membrane/trace carry
that survives arbitrary chunk arrivals, lane reassignments, idle eviction
to disk, and process restarts -- while every readout stays **bit-exact
with the unchunked serial ``run_int``** on the concatenated input.

How a stream runs:

* ``open`` registers a session (sliding-readout ``window``/``stride``, an
  ``idle_budget``, a scheduler ``tenant``).  No lane is held while idle --
  a million open sessions cost a million small host carries, not lanes.
* ``feed`` appends raster steps to the session's pending buffer.  The
  manager packages pending data into *chunk requests* -- ordinary
  :class:`~repro_torch.serve.snn_engine.SNNRequest`s in the scheduler's
  ``STREAMING`` class carrying ``_carry_in`` (the stream's carry, restored
  at admission instead of zeroing the lane) and ``_want_carry`` /
  ``_record_steps`` (the post-chunk carry and per-step output spikes come
  back at completion).  At most one chunk per session is in flight, so the
  carry chain is sequential; chunk size is capped so one hot stream cannot
  squat a lane (``max_chunk_steps``).
* Completed chunks feed the **sliding-window readout**: every ``stride``
  global steps the session emits the output-layer spike counts over the
  last ``window`` steps (plus the argmax prediction) -- rate-coded
  classification over an endless stream.
* A session idle for ``idle_budget`` consecutive manager polls is
  **evicted**: its carry + readout tail snapshot to ``repro_torch.checkpoint``
  (CRC-verified on the way back in) and the host copy is dropped.  The
  next ``feed`` restores it -- bit-exactly, enforced by the property suite
  (evict->restore->continue == never-evicted).
* ``close`` finalises the session and returns its lifetime summary.

The engine keeps one lane-window call per tick for the whole pool: chunk
requests ride the same ``batched_lane_window`` as everything else
(including the ``"event-pallas"`` sparse route when the cohort fits the
budget); the only new device work is one ``lane_state_put`` per admission
and one batched carry gather (``lane_states_take``) per tick that
completes chunks.

Sync vs async: :class:`StreamSessionManager` is the synchronous core
(drive it with ``poll()``/``pump()``; benchmarks and the ``--streaming``
launcher use it directly).  :class:`AsyncStreamServer` is the asyncio
facade the HTTP front-end (``/session/*`` routes) wraps: chunk futures ride
:class:`~repro_torch.serve.snn_engine.AsyncSNNServer`, so an engine stall fails
every waiting feed with ``EngineStalledError`` instead of hanging it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import TYPE_CHECKING, Callable

import numpy as np

from repro_torch.checkpoint.checkpointer import CheckpointCorruptError, Checkpointer
from repro_torch.core.snn_layer import LayerState
from repro_torch.serve.scheduler import Priority
from repro_torch.serve.snn_engine import AsyncSNNServer, SNNRequest, SNNServeEngine

if TYPE_CHECKING:  # pragma: no cover
    import pathlib

__all__ = [
    "StreamConfig",
    "Readout",
    "StreamSession",
    "StreamSessionManager",
    "AsyncStreamServer",
    "StreamError",
    "UnknownSessionError",
    "SessionClosedError",
    "StreamOverflowError",
]


class StreamError(RuntimeError):
    """Base class for streaming-session protocol errors."""


class UnknownSessionError(StreamError):
    """No session with that id was ever opened (HTTP 404)."""


class SessionClosedError(StreamError):
    """The session was already closed; feeds and re-closes are refused
    (HTTP 409)."""


class StreamOverflowError(StreamError):
    """The session's pending buffer is full -- back-pressure, not data loss
    (HTTP 429): the client must wait for in-flight chunks to drain."""


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Per-session streaming knobs.

    ``window``/``stride`` parameterise the sliding readout: every
    ``stride`` global steps, emit output-layer spike counts over the last
    ``window`` steps (a readout's early windows are truncated at stream
    start).  ``idle_budget`` is how many consecutive idle manager polls a
    session survives before its carry is evicted to the checkpoint store
    (``None`` = never evict).  ``priority``/``tenant`` place the session's
    chunk requests in the scheduler (class credits + tenant WFQ).
    ``max_pending_steps`` bounds the unsubmitted buffer (back-pressure);
    ``max_chunk_steps`` caps how many steps one chunk request carries, so
    a firehose stream shares lanes instead of squatting one.
    """

    window: int = 16
    stride: int = 8
    idle_budget: int | None = 64
    priority: Priority = Priority.STREAMING
    tenant: str = "stream"
    max_pending_steps: int = 4096
    max_chunk_steps: int = 256

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        if self.idle_budget is not None and self.idle_budget < 1:
            raise ValueError(f"idle_budget must be >= 1 or None, got {self.idle_budget}")
        if self.max_pending_steps < 1 or self.max_chunk_steps < 1:
            raise ValueError("max_pending_steps and max_chunk_steps must be >= 1")
        object.__setattr__(self, "priority", Priority(self.priority))


@dataclasses.dataclass
class Readout:
    """One sliding-window readout: the stream's rate-code answer at a
    stride boundary.  ``t_end`` is the global step the window ends at
    (exclusive); ``window`` the steps actually covered (< the configured
    window near stream start); ``latency_s`` feed-arrival -> readout."""

    seq: int
    t_end: int
    window: int
    spike_counts: np.ndarray  # [n_classes] int64
    prediction: int
    latency_s: float | None = None

    def to_json(self) -> dict:
        return {
            "seq": self.seq,
            "t_end": self.t_end,
            "window": self.window,
            "spike_counts": self.spike_counts.tolist(),
            "prediction": self.prediction,
            "latency_s": self.latency_s,
        }


@dataclasses.dataclass
class StreamSession:
    """One persistent stream: host-side carry + readout accumulator.

    ``state`` walks ``live -> (evicted <-> live) -> closed``; the carry is
    host-resident while live (``None`` until the first chunk completes),
    on disk while evicted, and discarded at close.
    """

    sid: str
    config: StreamConfig
    state: str = "live"  # "live" | "evicted" | "closed"
    carry: list | None = None  # per-layer LayerState numpy snapshot
    t_total: int = 0  # global steps absorbed into readouts
    fed_steps: int = 0  # global steps accepted by feed()
    counts_total: np.ndarray | None = None  # [n_classes] lifetime spikes
    pending: list = dataclasses.field(default_factory=list)  # unsubmitted chunks
    pending_steps: int = 0
    in_flight: bool = False
    idle_rounds: int = 0
    n_chunks: int = 0
    n_readouts: int = 0
    n_evictions: int = 0
    n_restores: int = 0
    readouts: list = dataclasses.field(default_factory=list)  # undelivered
    error: str | None = None
    _tail: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _listeners: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def drained(self) -> bool:
        """No buffered data and no chunk in flight."""
        return not self.pending and not self.in_flight

    def summary(self) -> dict:
        return {
            "session": self.sid,
            "state": self.state,
            "t_total": self.t_total,
            "fed_steps": self.fed_steps,
            "chunks": self.n_chunks,
            "readouts": self.n_readouts,
            "evictions": self.n_evictions,
            "restores": self.n_restores,
            "spike_counts": None
            if self.counts_total is None
            else self.counts_total.tolist(),
            "window": self.config.window,
            "stride": self.config.stride,
        }


class StreamSessionManager:
    """Session registry + chunk pipeline over one :class:`SNNServeEngine`.

    Synchronous core: ``open``/``feed``/``close`` mutate sessions,
    ``poll()`` runs one service round (launch ready chunks, one engine
    poll, idle accounting + eviction), ``pump()`` polls until every
    session drains.  The asyncio facade (:class:`AsyncStreamServer`)
    reuses everything except the launch loop, which it drives through the
    async server so futures propagate engine failures.

    ``checkpoint_dir`` enables idle eviction and bit-exact resume:
    each session snapshots to ``<dir>/<sid>/step_<t_total>`` through
    :class:`~repro_torch.checkpoint.checkpointer.Checkpointer` (atomic commit,
    CRC-verified restore).  Without it, idle sessions simply stay host-
    resident.
    """

    def __init__(
        self,
        engine: SNNServeEngine,
        *,
        checkpoint_dir: "str | pathlib.Path | None" = None,
        config: StreamConfig | None = None,
        keep_checkpoints: int = 2,
    ):
        self.engine = engine
        self.default_config = config if config is not None else StreamConfig()
        self.checkpoint_dir = checkpoint_dir
        self.keep_checkpoints = keep_checkpoints
        self.sessions: dict[str, StreamSession] = {}
        self.n_opened = 0
        self._sid_seq = itertools.count(1)
        self._uid_seq = itertools.count(1 << 40)  # chunk uids: own namespace
        self._by_chunk: dict[int, StreamSession] = {}  # uid -> session

    @property
    def metrics(self):
        # read through: engine.warmup() swaps in a fresh ServeMetrics
        return self.engine.metrics

    @property
    def _journal(self):
        # read through to the engine's WAL (wired by the supervisor): the
        # manager journals the *session* record stream -- open / feed /
        # evict / close -- while the engine deliberately skips journaling
        # the chunk requests themselves (they are derived state; recovery
        # rebuilds them from these records + the checkpointed carry seam)
        return self.engine.journal

    # -- accounting (the soak test's conservation invariants) ----------------
    def conservation(self) -> dict:
        live = sum(s.state == "live" for s in self.sessions.values())
        evicted = sum(s.state == "evicted" for s in self.sessions.values())
        closed = sum(s.state == "closed" for s in self.sessions.values())
        return {"opened": self.n_opened, "live": live, "evicted": evicted, "closed": closed}

    def _update_gauges(self) -> None:
        c = self.conservation()
        self.metrics.live_sessions = c["live"]
        self.metrics.evicted_sessions = c["evicted"]

    def _get(self, sid: str, *, for_feed: bool = False) -> StreamSession:
        s = self.sessions.get(sid)
        if s is None:
            raise UnknownSessionError(f"unknown session {sid!r}")
        if s.state == "closed":
            raise SessionClosedError(f"session {sid!r} is closed")
        if for_feed and s.state == "evicted":
            self._restore(s)
        return s

    # -- lifecycle -----------------------------------------------------------
    def open(self, sid: str | None = None, **overrides) -> StreamSession:
        """Register a new stream.  ``overrides`` replace fields of the
        manager's default :class:`StreamConfig` for this session."""
        if sid is None:
            sid = f"s{next(self._sid_seq)}"
        if sid in self.sessions:
            raise ValueError(f"session {sid!r} already exists")
        cfg = (
            dataclasses.replace(self.default_config, **overrides)
            if overrides
            else self.default_config
        )
        s = StreamSession(sid=sid, config=cfg)
        self.sessions[sid] = s
        self.n_opened += 1
        if self._journal is not None:
            self._journal.append(
                "session_open",
                sid=sid,
                config={
                    k: int(v) if isinstance(v, Priority) else v
                    for k, v in overrides.items()
                },
            )
        self.metrics.inc("sessions_opened")
        self._update_gauges()
        return s

    def feed(self, sid: str, chunk) -> StreamSession:
        """Append raster steps (int [s, n_in]) to a session's stream.

        Restores an evicted session first; raises
        :class:`StreamOverflowError` when the pending buffer is full
        (back-pressure -- nothing was accepted)."""
        s = self._get(sid, for_feed=True)
        chunk = np.asarray(chunk)
        if chunk.ndim != 2 or chunk.shape[1] != self.engine.net.n_in:
            raise ValueError(
                f"session {sid!r}: chunk must be [steps, {self.engine.net.n_in}], "
                f"got shape {tuple(chunk.shape)}"
            )
        if chunk.shape[0] < 1:
            raise ValueError(f"session {sid!r}: empty chunk")
        if s.pending_steps + chunk.shape[0] > s.config.max_pending_steps:
            raise StreamOverflowError(
                f"session {sid!r}: pending buffer full "
                f"({s.pending_steps} + {chunk.shape[0]} > "
                f"{s.config.max_pending_steps} steps); drain before feeding more"
            )
        if self._journal is not None:
            # the accepted steps must survive a crash: record them with the
            # session's pre-feed global offset, so recovery can reassemble
            # the stream suffix by offset (overlap-safe across recoveries)
            self._journal.append(
                "feed", arrays={"chunk": chunk}, sid=sid, start=s.fed_steps
            )
        s.pending.append(chunk)
        s.pending_steps += chunk.shape[0]
        s.fed_steps += chunk.shape[0]
        s.idle_rounds = 0
        return s

    def close(self, sid: str) -> dict:
        """Finalise a session and return its lifetime summary.  An evicted
        session closes without being restored (its checkpoint is simply
        abandoned to the checkpointer's GC); an in-flight chunk completes
        and is absorbed, but launches nothing further."""
        s = self.sessions.get(sid)
        if s is None:
            raise UnknownSessionError(f"unknown session {sid!r}")
        if s.state == "closed":
            raise SessionClosedError(f"session {sid!r} is already closed")
        s.state = "closed"
        s.pending.clear()
        s.pending_steps = 0
        s.carry = None
        s._tail = None
        if self._journal is not None:
            self._journal.append("session_close", sid=sid)
        self.metrics.inc("sessions_closed")
        self._update_gauges()
        summary = s.summary()
        for cb in s._listeners:
            cb(None)  # end-of-stream sentinel for subscribers
        s._listeners.clear()
        return summary

    def subscribe(self, sid: str, callback: Callable) -> None:
        """Register ``callback(readout | None)``: called for every readout
        as it is produced, then once with ``None`` at close."""
        self._get(sid)._listeners.append(callback)

    # -- the chunk pipeline --------------------------------------------------
    def launch_next(self, s: StreamSession) -> SNNRequest | None:
        """Package pending steps into the session's next chunk request.

        Returns ``None`` when the session has nothing to launch or already
        has a chunk in flight (the carry chain is strictly sequential).
        The caller submits the returned request (``engine.submit`` or the
        async server) -- the manager only builds and tracks it.
        """
        if s.state != "live" or s.in_flight or not s.pending:
            return None
        cap = s.config.max_chunk_steps
        take, n = [], 0
        while s.pending and n + s.pending[0].shape[0] <= cap:
            c = s.pending.pop(0)
            take.append(c)
            n += c.shape[0]
        if not take:  # first pending chunk alone exceeds the cap: split it
            c = s.pending[0]
            take.append(c[:cap])
            s.pending[0] = c[cap:]
            n = cap
        s.pending_steps -= n
        raster = take[0] if len(take) == 1 else np.concatenate(take, axis=0)
        req = SNNRequest(
            uid=next(self._uid_seq),
            raster=raster,
            priority=s.config.priority,
            tenant=s.config.tenant,
            on_complete=self._chunk_done,
        )
        req._carry_in = None if s.carry is None else s.carry
        req._want_carry = True
        req._record_steps = True
        s.in_flight = True
        s.idle_rounds = 0
        self._by_chunk[req.uid] = s
        return req

    def _chunk_done(self, req: SNNRequest) -> None:
        """Completion hook (runs inside ``engine.poll``): absorb the chunk's
        carry and per-step outputs into the session."""
        s = self._by_chunk.pop(req.uid, None)
        if s is None:  # pragma: no cover - defensive: unknown chunk
            return
        s.in_flight = False
        s.n_chunks += 1
        self.metrics.inc("session_chunks")
        if req.status != "completed":  # pragma: no cover - streaming chunks
            s.error = f"chunk {req.uid} ended {req.status!r}"  # carry no deadline
            return
        if s.state == "closed":
            return  # closed mid-flight: result discarded, nothing relaunched
        s.carry = req.carry_out
        now = time.perf_counter()
        latency = None if req._arrival_wall is None else now - req._arrival_wall
        self._absorb(s, req.step_outputs, latency, now)

    def _absorb(
        self, s: StreamSession, steps: np.ndarray, latency: float | None, now: float
    ) -> None:
        """Fold per-step output spikes into the sliding-window readout.

        ``steps`` is [n, n_classes]; the session keeps the last
        ``window - 1`` step vectors as its cross-chunk tail, so a window
        spanning a chunk boundary sums exactly the same per-step vectors
        the unchunked run would.
        """
        steps = np.asarray(steps, np.int64)
        cfg = s.config
        if s.counts_total is None:
            s.counts_total = np.zeros(steps.shape[1], np.int64)
        s.counts_total += steps.sum(axis=0)
        tail = s._tail if s._tail is not None else steps[:0]
        base = s.t_total - tail.shape[0]  # global index of buf[0]
        buf = np.concatenate([tail, steps], axis=0)
        cs = np.concatenate(
            [np.zeros((1, buf.shape[1]), np.int64), np.cumsum(buf, axis=0)], axis=0
        )
        t0, t1 = s.t_total, s.t_total + steps.shape[0]
        b = (t0 // cfg.stride + 1) * cfg.stride
        while b <= t1:
            start = max(0, b - cfg.window)
            counts = cs[b - base] - cs[start - base]
            r = Readout(
                seq=s.n_readouts,
                t_end=b,
                window=b - start,
                spike_counts=counts,
                prediction=int(np.argmax(counts)),
                latency_s=latency,
            )
            s.n_readouts += 1
            s.readouts.append(r)
            self.metrics.inc("session_readouts")
            if latency is not None:
                self.metrics.readout_latency.add(latency, now)
            for cb in s._listeners:
                cb(r)
            b += cfg.stride
        s.t_total = t1
        keep = min(cfg.window - 1, buf.shape[0])
        s._tail = buf[buf.shape[0] - keep :]

    def drain_readouts(self, sid: str) -> list[Readout]:
        """Take (and clear) the session's undelivered readouts."""
        s = self.sessions.get(sid)
        if s is None:
            raise UnknownSessionError(f"unknown session {sid!r}")
        out, s.readouts = s.readouts, []
        return out

    # -- eviction / restore --------------------------------------------------
    def _ckpt(self, sid: str) -> Checkpointer:
        if self.checkpoint_dir is None:
            raise StreamError("no checkpoint_dir configured")
        import pathlib

        return Checkpointer(
            pathlib.Path(self.checkpoint_dir) / sid,
            keep=self.keep_checkpoints,
            faults=self.engine.faults,  # chaos: torn-checkpoint injection
        )

    def _carry_template(self) -> list:
        # int32 for all three leaves, as the lane pool (int_layer_init) holds them
        return [
            LayerState(
                u=np.zeros((cfg.n_out,), np.int32),
                i_syn=np.zeros((cfg.n_out,), np.int32),
                prev_spk=np.zeros((cfg.n_out,), np.int32),
            )
            for cfg in self.engine.net.layers
        ]

    def evict(self, sid: str) -> None:
        """Snapshot a live, drained session's carry to disk and drop the
        host copy.  Fresh sessions (no completed chunk yet) have no carry
        to park and stay live."""
        s = self._get(sid)
        if not s.drained:
            raise StreamError(f"session {sid!r} has data in flight; cannot evict")
        if s.carry is None:
            return
        tail = s._tail if s._tail is not None else np.zeros((0, 1), np.int64)
        self._ckpt(sid).save(
            s.t_total,
            {"carry": s.carry, "tail": tail},
            user_state={
                "sid": s.sid,
                "t_total": s.t_total,
                "fed_steps": s.fed_steps,
                "n_readouts": s.n_readouts,
                "n_chunks": s.n_chunks,
                "counts_total": [] if s.counts_total is None else s.counts_total.tolist(),
                "window": s.config.window,
                "stride": s.config.stride,
            },
            blocking=True,  # small host arrays; a racing restore must see them
        )
        s.carry = None
        s._tail = None
        s.state = "evicted"
        s.n_evictions += 1
        if self._journal is not None:
            # journaled strictly *after* the blocking save committed: a
            # crash in between leaves the checkpoint ahead of the journal,
            # which recovery resolves in the checkpoint's favour
            self._journal.append("evict", sid=sid, t_total=s.t_total)
        self.metrics.inc("sessions_evicted")
        self._update_gauges()

    def _restore(self, s: StreamSession) -> None:
        """Load an evicted session's carry back from its checkpoint,
        CRC-verified; shape-check against the serving network so a
        checkpoint from some other net can never smuggle in a wrong-shaped
        carry."""
        template = {"carry": self._carry_template(), "tail": np.zeros((0, 1), np.int64)}
        try:
            tree, user = self._ckpt(s.sid).restore(template)
        except (CheckpointCorruptError, FileNotFoundError, KeyError) as e:
            raise StreamError(
                f"session {s.sid!r}: cannot restore from checkpoint: {e}"
            ) from e
        for li, (got, want) in enumerate(zip(tree["carry"], template["carry"])):
            for field in LayerState._fields:
                g, w = getattr(got, field), getattr(want, field)
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise StreamError(
                        f"session {s.sid!r}: checkpoint carry layer {li} field "
                        f"{field} is {g.shape}/{g.dtype}, serving net expects "
                        f"{w.shape}/{w.dtype} -- wrong network?"
                    )
        if user.get("t_total") != s.t_total:
            raise StreamError(
                f"session {s.sid!r}: checkpoint is at step {user.get('t_total')}, "
                f"session expects {s.t_total}"
            )
        s.carry = list(tree["carry"])
        tail = np.asarray(tree["tail"], np.int64)
        s._tail = tail if tail.size else None
        s.state = "live"
        s.n_restores += 1
        self.metrics.inc("sessions_restored")
        self._update_gauges()

    # -- the sync drive loop -------------------------------------------------
    def poll(self) -> list[SNNRequest]:
        """One service round: launch every ready chunk, run one engine
        poll, then account idleness and evict over-budget sessions."""
        for s in self.sessions.values():
            req = self.launch_next(s)
            while req is not None:
                self.engine.submit(req)
                req = self.launch_next(s)  # at most one in flight: stops
        done = self.engine.poll() if self.engine.in_flight else []
        for s in self.sessions.values():
            if s.state != "live":
                continue
            if s.drained:
                s.idle_rounds += 1
                if (
                    s.config.idle_budget is not None
                    and s.idle_rounds > s.config.idle_budget
                    and self.checkpoint_dir is not None
                    and s.carry is not None
                ):
                    self.evict(s.sid)
            else:
                s.idle_rounds = 0
        return done

    def pump(self, max_polls: int = 100_000) -> None:
        """Poll until every session drains (tests / the sync launcher)."""
        for _ in range(max_polls):
            if all(s.drained for s in self.sessions.values()):
                return
            self.poll()
        raise StreamError(f"sessions failed to drain within {max_polls} polls")


class AsyncStreamServer:
    """asyncio facade: sessions over :class:`AsyncSNNServer` futures.

    ``feed`` buffers the chunk, then drives the session's chunk chain
    through ``server.submit`` -- each chunk's future resolves when the
    engine completes it (bookkeeping already done by the manager's
    ``on_complete``), and an engine failure (e.g. ``EngineStalledError``)
    fails the future instead of hanging the HTTP handler.  ``idle_tick``
    is called by the HTTP server's housekeeping task to advance idle
    accounting/eviction while no request traffic is flowing.
    """

    def __init__(self, server: AsyncSNNServer, manager: StreamSessionManager):
        self.server = server
        self.manager = manager
        self._locks: dict[str, asyncio.Lock] = {}

    def _lock(self, sid: str) -> asyncio.Lock:
        return self._locks.setdefault(sid, asyncio.Lock())

    def open(self, sid: str | None = None, **overrides) -> StreamSession:
        return self.manager.open(sid, **overrides)

    def close(self, sid: str) -> dict:
        self._locks.pop(sid, None)
        return self.manager.close(sid)

    async def feed(self, sid: str, chunk) -> tuple[StreamSession, list[Readout]]:
        """Feed one chunk and drive the session until it drains; returns
        the session and the readouts this feed produced.  Serialised per
        session, so concurrent feeds keep stream order."""
        async with self._lock(sid):
            s = self.manager.feed(sid, chunk)
            while not s.drained and s.state == "live":
                req = self.manager.launch_next(s)
                if req is not None:
                    # shield: a vanishing HTTP client must not cancel the
                    # chunk future -- bookkeeping rides its resolution
                    await asyncio.shield(self.server.submit(req))
                else:  # in flight from elsewhere: wait a beat
                    await asyncio.sleep(0)
                    if self.server.error is not None:
                        raise self.server.error
            return s, self.manager.drain_readouts(sid)

    def idle_tick(self) -> None:
        """One idle-accounting round (no engine work): sessions with
        nothing buffered age toward eviction."""
        for s in self.manager.sessions.values():
            if s.state != "live" or not s.drained:
                continue
            s.idle_rounds += 1
            if (
                s.config.idle_budget is not None
                and s.idle_rounds > s.config.idle_budget
                and self.manager.checkpoint_dir is not None
                and s.carry is not None
            ):
                self.manager.evict(s.sid)
