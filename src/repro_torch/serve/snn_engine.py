"""NeurA-Serve: continuous-batching inference service for quantized SNNs.

Port of ``repro/serve/snn_engine.py``.  A fixed pool of ``max_batch``
**lanes** holds in-flight samples on the device; each tick one call of
``batched_lane_window`` advances every active lane by a chunk of time steps
at its *own* local step, and a finished sample frees its lane immediately
(continuous batching).  Lanes never interact, so every request is bit-exact
with a serial single-sample ``run_int``.

Routes, as in the JAX engine:

* ``"lanes"`` -- the dense lane program; the feed-forward product is the
  certified f32 GEMM (``ff_mode="f32_exact"``) when every active lane's
  input values stay under the f32 bound, else the exact int32 product
  (``"int32"``, the ``spike_matmul`` kernel on the card);
* ``"event-pallas"`` -- with ``EventBackend(strategy="pallas")`` sparse
  requests stay in the pool and a tick whose whole cohort fits the static
  event budget takes the fixed-capacity sparse path for layer 0
  (``sparse_accum`` on the card);
* ``"event-<strategy>"`` -- with an eager event strategy (gather / csr)
  sparse requests are served one at a time outside the pool;
* ``"degraded"`` -- deadline degradation to a registered
  :class:`~repro_torch.serve.scheduler.PrecisionTier` through one ragged
  ``run_int_batched`` call.

The control plane (``scheduler`` + ``metrics``: priority classes, tenant
fairness, preemption, deadline verdicts, rolling latency windows) is the
JAX engine's host Python, unchanged.  So are the NeurA-Guard seams:
``journal=`` (:mod:`repro_torch.serve.journal`) records admissions and
terminal states, ``faults=`` (:mod:`repro_torch.serve.faults`) fires the
chaos injector's tick and carry sites, and ``sweep_carries`` /
``quarantine_lane`` let the supervisor condemn a lane whose carry left its
bounds.  The streaming seams (``_carry_in`` / ``_want_carry`` /
``_record_steps`` on a request) let :mod:`repro_torch.serve.streaming` run
a stream as a chain of chunk requests over persistent carries.

Two device-side differences from the JAX engine: the carries of every lane
that finishes in a tick come back in one gather and one copy
(``lane_states_take``), and the validity sweep is one bounds check over the
whole pool on the device that reads back one mask of bad slots.  The engine
runs on one device: ``data_parallel`` clamps to 1.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import hw_model
from repro_torch.core.backend import (
    EventBackend,
    InferenceBackend,
    batched_lane_init,
    batched_lane_window,
    get_backend,
    lane_state_put,
    lane_state_take,
    lane_states_take,
    run_int_batched,
)
from repro_torch.core.fixed_point import int_max, int_min
from repro_torch.core.network import NetworkConfig, run_int
from repro_torch.core.snn_layer import IntLayerParams
from repro_torch.kernels import build
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import PrecisionTier, Priority, SchedPolicy, Scheduler

__all__ = [
    "SNNRequest",
    "SNNServeEngine",
    "AsyncSNNServer",
    "EngineStalledError",
]


class EngineStalledError(RuntimeError):
    """``poll()``/``drain()`` made no progress for ``max_idle_ticks``
    consecutive rounds while requests were still queued; carries the
    scheduler's queue snapshot and the lane table (``err.queue_snapshot`` /
    ``err.lane_states``)."""

    def __init__(self, msg: str, queue_snapshot: dict, lane_states: list):
        super().__init__(msg)
        self.queue_snapshot = queue_snapshot
        self.lane_states = lane_states


@dataclasses.dataclass
class SNNRequest:
    """One inference request: a single sample's spike raster.

    ``raster`` is int [T, n_in] (numpy); T may differ per request.
    ``arrival_s`` is the offset from the start of ``SNNServeEngine.run``.
    QoS fields: ``priority``, ``tenant`` and ``deadline_s`` (a latency SLO
    from arrival).  ``on_complete`` runs at any terminal state; a raising
    callback is counted and never takes the engine down.  The engine fills
    the result fields at the terminal state.
    """

    uid: int
    raster: np.ndarray
    arrival_s: float = 0.0
    priority: Priority | int = Priority.STANDARD
    tenant: str = "default"
    deadline_s: float | None = None
    on_complete: "Callable[[SNNRequest], None] | None" = dataclasses.field(
        default=None, repr=False
    )
    # -- filled by the engine at the terminal state --------------------------
    spike_counts: np.ndarray | None = None  # [n_classes] output spike totals
    prediction: int | None = None
    route: str | None = None  # "lanes" | "event-*" | "degraded"
    latency_s: float | None = None  # terminal - arrival (queueing included)
    service_s: float | None = None  # terminal - admission
    status: str | None = None  # "completed" | "degraded" | "rejected"
    tier: str | None = None  # "full" | registered tier name (None if rejected)
    preemptions: int = 0
    restarts: int = 0  # quarantine / crash-recovery re-admissions
    admitted_seq: int | None = None  # first-admission order (FIFO property)
    _arrival_wall: float | None = dataclasses.field(default=None, repr=False)
    _net: "NetworkConfig | None" = dataclasses.field(default=None, repr=False)
    _stats_src: tuple | None = dataclasses.field(default=None, repr=False)
    _stats: dict | None = dataclasses.field(default=None, repr=False)
    _design: hw_model.DesignPoint | None = dataclasses.field(default=None, repr=False)
    _max_val: int = dataclasses.field(default=0, repr=False)
    _max_step_events: int = dataclasses.field(default=0, repr=False)
    _sched_seq: int | None = dataclasses.field(default=None, repr=False)
    _suspended: tuple | None = dataclasses.field(default=None, repr=False)
    _finalized: bool = dataclasses.field(default=False, repr=False)
    # -- streaming-session seam (repro_torch.serve.streaming) ----------------
    # A chunk request continues a persistent stream: ``_carry_in`` is a
    # lane_state_take snapshot restored at admission instead of zeroing the
    # lane, ``_want_carry`` asks for the post-window carry back on
    # ``carry_out``, and ``_record_steps`` keeps the final layer's per-step
    # spike vectors on ``step_outputs`` (the sliding-window readout input).
    _carry_in: list | None = dataclasses.field(default=None, repr=False)
    _want_carry: bool = dataclasses.field(default=False, repr=False)
    _record_steps: bool = dataclasses.field(default=False, repr=False)
    carry_out: list | None = dataclasses.field(default=None, repr=False)
    step_outputs: np.ndarray | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.priority = Priority(self.priority)  # raises on unknown classes
        if self.deadline_s is not None:
            self.deadline_s = float(self.deadline_s)
        self.raster = np.asarray(self.raster)
        if self.raster.ndim != 2:
            raise ValueError(
                f"request {self.uid}: raster must be [T, n_in], got shape {self.raster.shape}"
            )
        if self.raster.shape[0] < 1:
            raise ValueError(f"request {self.uid}: empty window")
        # spike values are tiny non-negative ints; a uint8 raster quarters the
        # bytes every serving tick copies to the device
        if self.raster.size:
            lo, hi = int(self.raster.min()), int(self.raster.max())
            self._max_val = max(abs(lo), abs(hi))
            if self.raster.dtype != np.uint8:
                self.raster = self.raster.astype(np.uint8 if 0 <= lo and hi <= 255 else np.int32)
        self._density = float(np.count_nonzero(self.raster)) / max(1, self.raster.size)
        # max active channels in any single step: the sparse lane route's
        # capacity check (the event budget bounds a *step*, not the mean)
        self._max_step_events = int(np.count_nonzero(self.raster, axis=-1).max(initial=0))

    @property
    def n_steps(self) -> int:
        return self.raster.shape[0]

    @property
    def density(self) -> float:
        """Fraction of nonzero raster entries (the admission-policy signal)."""
        return self._density

    @property
    def done(self) -> bool:
        return self.spike_counts is not None

    @property
    def finished(self) -> bool:
        """Terminal: completed, degraded, or rejected (exactly once)."""
        return self.status is not None

    @property
    def event_stats(self) -> dict | None:
        """This request's measured event traffic, ``SimRecord.event_stats``
        shaped, assembled lazily (off the serving hot path)."""
        if self._stats is None and self._stats_src is not None:
            kind, payload = self._stats_src
            if kind == "record":
                self._stats = payload.event_stats()
            elif kind == "batch":  # (SimRecord, sample index, true window)
                rec, b, Tb = payload
                self._stats = {
                    "input_events_per_step": rec.input_events[:Tb, b]
                    .cpu()
                    .numpy()
                    .astype(np.float64),
                    "layer_events_per_step": [
                        s[:Tb, b].cpu().numpy().astype(np.float64) for s in rec.layer_spikes
                    ],
                }
            else:  # per-lane chunks: list of [k_i, n_layers] emitted counts
                per_step = np.concatenate(payload, axis=0).astype(np.float64)
                self._stats = {
                    "input_events_per_step": np.count_nonzero(self.raster, axis=-1).astype(
                        np.float64
                    )[: per_step.shape[0]],
                    "layer_events_per_step": [per_step[:, l] for l in range(per_step.shape[1])],
                }
        return self._stats

    @property
    def design(self) -> hw_model.DesignPoint | None:
        """Modeled hardware operating point at this request's measured traffic."""
        if self._design is None and self._net is not None and self.event_stats is not None:
            self._design = hw_model.design_point(
                self._net, hw_model.EventTraffic.from_stats(self.event_stats)
            )
        return self._design


def _lane_window_packed(net, qparams, states, x_chunk, lane_meta, ff_mode, event_budget=None):
    """``batched_lane_window`` with packed aux input and packed output.

    ``lane_meta`` int32 [2, n_lanes] carries ``(reset_flags, valid_steps)``
    in one host->device copy, and the final-layer spikes + per-layer emitted
    counts come back as one [k, n_lanes, n_classes + n_layers] tensor: one
    device->host copy per tick.  ``states`` (the preallocated lane pool) is
    updated in place.
    """
    _, out, emitted = batched_lane_window(
        net,
        qparams,
        states,
        x_chunk,
        lane_meta[0] != 0,
        valid_steps=lane_meta[1],
        ff_mode=ff_mode,
        event_budget=event_budget,
    )
    return torch.cat([out, emitted.permute(0, 2, 1)], dim=-1)


@dataclasses.dataclass
class _Lane:
    """Host-side bookkeeping for one occupied lane."""

    req: SNNRequest
    admitted_wall: float
    t: int = 0  # next local step to feed
    fresh: bool = True  # device state must be zeroed on the next tick
    counts: np.ndarray | None = None  # [n_classes] running output spikes
    layer_events: list = dataclasses.field(default_factory=list)  # per tick [valid, L]
    step_out: list | None = None  # per tick [valid, n_classes] (streaming readout)
    carry0: list | None = None  # chunk-start carry snapshot (quarantine restart)


class SNNServeEngine:
    """Continuous-batching SNN inference over a fixed lane pool.

    ``backend`` selects the serving strategy: the lane pool always advances
    through the shared batched lane window (reference numerics), and an
    :class:`~repro_torch.core.backend.EventBackend` adds the density-based
    admission policy (``"event-pallas"`` in-pool sparse route for the
    pallas strategy, the direct eager route otherwise).  ``tick_stride``
    caps the power-of-two chunk length one tick advances; per-lane
    ``valid_steps`` absorbs the overshoot.  ``scheduler`` /
    ``precision_tiers`` / ``max_idle_ticks`` / ``report_design_point`` are
    the JAX engine's control-plane knobs.

    ``journal`` (a :class:`~repro_torch.serve.journal.Journal`) records
    admissions and terminal states for crash recovery; ``faults`` (a
    :class:`~repro_torch.serve.faults.FaultInjector`) fires the chaos
    sites of the tick loop.  Both default off and cost nothing when absent.

    ``device`` (default ``"cuda"``) holds the lane pool and the parameters
    (moved there if they live elsewhere).  ``data_parallel`` is accepted for
    API parity and clamps to one device.
    """

    def __init__(
        self,
        net: NetworkConfig,
        qparams: Sequence,
        *,
        max_batch: int = 8,
        backend: str | InferenceBackend = "reference",
        sparse_admission_threshold: float = 0.10,
        tick_stride: int | None = 32,
        report_design_point: bool = True,
        data_parallel: int | None = None,
        scheduler: "SchedPolicy | Scheduler | None" = None,
        precision_tiers: Sequence[PrecisionTier] = (),
        max_idle_ticks: int | None = 1000,
        metrics_window_s: float = 60.0,
        journal=None,
        faults=None,
        device: str | torch.device = "cuda",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if data_parallel is not None and data_parallel < 1:
            raise ValueError(f"data_parallel must be >= 1 or None, got {data_parallel}")
        if tick_stride is not None and tick_stride < 1:
            raise ValueError(f"tick_stride must be >= 1 or None, got {tick_stride}")
        if not 0.0 <= sparse_admission_threshold <= 1.0:
            raise ValueError(
                f"sparse_admission_threshold must be in [0, 1], got {sparse_admission_threshold}"
            )
        if max_idle_ticks is not None and max_idle_ticks < 1:
            raise ValueError(f"max_idle_ticks must be >= 1 or None, got {max_idle_ticks}")
        self.device = resolve_device(device)
        self.net = net
        self.qparams = [_on(p, self.device) for p in qparams]
        self.max_batch = max_batch
        resolved = get_backend(backend)
        self.backend_name = resolved.name
        self.event_backend = resolved if isinstance(resolved, EventBackend) else None
        self.sparse_admission_threshold = sparse_admission_threshold
        self.tick_stride = tick_stride
        self.report_design_point = report_design_point
        self.sched = scheduler if isinstance(scheduler, Scheduler) else Scheduler(scheduler)
        for tier in precision_tiers:
            if tier.net.n_in != net.n_in or tier.net.n_classes != net.n_classes:
                raise ValueError(
                    f"precision tier {tier.name!r} does not match the serving "
                    f"network topology ({tier.net.n_in}ch/{tier.net.n_classes}cls "
                    f"vs {net.n_in}ch/{net.n_classes}cls)"
                )
        self.tiers: tuple[PrecisionTier, ...] = tuple(
            dataclasses.replace(t, qparams=tuple(_on(p, self.device) for p in t.qparams))
            for t in precision_tiers
        )
        self.max_idle_ticks = max_idle_ticks
        self.metrics = ServeMetrics(metrics_window_s)
        self.journal = journal
        self.faults = faults
        self.stop_admission = False  # graceful drain: refuse new submits
        # Slots the supervisor's validity sweep condemned: they hold no
        # lane, never admit, and only an engine restart reclaims them.
        self._quarantined: set[int] = set()
        # one device: every lane lives on it (the JAX engine's one-device
        # behaviour for any data_parallel)
        self.data_parallel = 1

        self._states = batched_lane_init(net, max_batch, device=self.device)
        self._lanes: list[_Lane | None] = [None] * max_batch
        self.n_ticks = 0  # chunk dispatches
        self.n_steps_run = 0  # simulated time steps advanced (sum of chunk lengths)
        self.n_served = 0
        self._admit_seq = 0  # first-admission counter (FIFO-order evidence)
        self._idle_rounds = 0  # consecutive no-progress polls (liveness guard)
        # Largest layer-0 input spike value for which the f32 feed-forward
        # path stays exact; deeper layers integrate {0,1} phase-B spikes, so
        # they only need the static per-layer bound to hold.
        bound = 2**24 - 1
        self._deep_f32_ok = all(int_max(c.w_bits) * c.n_in < bound for c in net.layers[1:])
        self._f32_input_max: int = 0
        if self._deep_f32_ok:
            l0 = net.layers[0]
            self._f32_input_max = bound // (int_max(l0.w_bits) * l0.n_in)
        # The in-pool sparse route: with an event backend resolving to the
        # pallas strategy, layer 0 of a tick takes the fixed-capacity path
        # whenever every active lane fits the budget (which doubles as the
        # f32 exactness certificate).
        self._event_budget: int | None = None
        self._sparse_val_max: int = 0
        if (
            self.event_backend is not None
            and self.event_backend.resolved_strategy(self.device) == "pallas"
        ):
            l0 = net.layers[0]
            self._event_budget = self.event_backend.serve_budget(
                l0.n_in, sparse_admission_threshold
            )
            self._sparse_val_max = bound // (int_max(l0.w_bits) * self._event_budget)

    # -- introspection ------------------------------------------------------
    @property
    def queue(self):
        """The scheduler (``len`` / truthiness / indexing / scheduling-order iteration)."""
        return self.sched

    @property
    def active_lanes(self) -> int:
        return sum(l is not None for l in self._lanes)

    @property
    def free_lanes(self) -> int:
        return self.max_batch - self.active_lanes - len(self._quarantined)

    @property
    def capacity(self) -> int:
        """Lanes not condemned by quarantine (active or free)."""
        return self.max_batch - len(self._quarantined)

    @property
    def quarantined(self) -> frozenset:
        return frozenset(self._quarantined)

    @property
    def in_flight(self) -> bool:
        return bool(self.sched) or self.active_lanes > 0

    # -- admission ----------------------------------------------------------
    def submit(self, req: SNNRequest) -> None:
        """Queue a request (arrival stamped now unless ``run`` set it)."""
        if self.stop_admission:
            raise RuntimeError(f"request {req.uid}: engine is draining, admission is stopped")
        if req.raster.shape[1] != self.net.n_in:
            raise ValueError(
                f"request {req.uid}: raster has {req.raster.shape[1]} channels, "
                f"network expects {self.net.n_in}"
            )
        if req._arrival_wall is None:
            req._arrival_wall = time.perf_counter()
        # WAL: the admission must survive a crash.  Streaming chunk requests
        # are the session manager's to journal (recovery rebuilds them from
        # the session's feeds and checkpointed carry).
        if self.journal is not None and not req._want_carry:
            self.journal.append(
                "submit",
                arrays={"raster": req.raster},
                uid=req.uid,
                priority=int(req.priority),
                tenant=req.tenant,
                deadline_s=req.deadline_s,
            )
        self.metrics.inc("submitted")
        self.sched.add(req)

    def _routes_to_event(self, req: SNNRequest) -> bool:
        """Direct (out-of-pool) sparse route: eager gather/csr strategies
        only, and never a streaming chunk (the direct route runs a
        fresh-state ``run_int``, which can neither restore nor return a
        carry)."""
        return (
            self.event_backend is not None
            and self._event_budget is None
            and req.density <= self.sparse_admission_threshold
            and req._carry_in is None
            and not req._want_carry
        )

    def _sparse_lane_eligible(self, req: SNNRequest) -> bool:
        """Admission rule for the in-pool ``"event-pallas"`` route: sparse
        enough, every step fits the event budget, values inside the budget's
        f32 exactness certificate."""
        return (
            self._event_budget is not None
            and req.density <= self.sparse_admission_threshold
            and req._max_step_events <= self._event_budget
            and req._max_val <= self._sparse_val_max
        )

    def _serve_event(self, req: SNNRequest) -> SNNRequest:
        """Direct sparse route: one single-sample event-backend run."""
        t0 = time.perf_counter()
        x = torch.from_numpy(req.raster[:, None, :].astype(np.int32)).to(self.device)
        rec = run_int(self.net, self.qparams, x, backend=self.event_backend)
        req.spike_counts = rec.spike_counts[0].cpu().numpy()
        req.route = f"event-{self.event_backend.resolved_strategy(self.device)}"
        self.metrics.direct_s += time.perf_counter() - t0
        self._finish(req, time.perf_counter(), stats_src=("record", rec))
        return req

    def _free_lane(self) -> int | None:
        for i, lane in enumerate(self._lanes):
            if lane is None and i not in self._quarantined:
                return i
        return None

    # -- the control plane: one dispatch round ------------------------------
    def _dispatch(self, now: float) -> list[SNNRequest]:
        """One scheduling round, in QoS order: direct sparse serves, the
        deadline sweep (keep / degrade / reject), preemption by queued
        CRITICALs, then admission into free lanes."""
        t0 = time.perf_counter()
        served_s = 0.0  # compute spent serving, excluded from dispatch_s
        done: list[SNNRequest] = []

        if self.event_backend is not None and self._event_budget is None and self.sched:
            for req in [r for r in self.sched if self._routes_to_event(r)]:
                self.sched.remove(req)
                s0 = time.perf_counter()
                done.append(self._serve_event(req))
                served_s += time.perf_counter() - s0

        degrade: list[tuple[SNNRequest, PrecisionTier]] = []
        if self.sched:
            deadlined = [r for r in self.sched if r.deadline_s is not None]
            if deadlined:
                step_s = self.metrics.est_step_s
                lane_backlog = sum(l.req.n_steps - l.t for l in self._lanes if l is not None)
                queue_backlog = sum(r.n_steps for r in self.sched)
                for req in deadlined:
                    if step_s is None:
                        wait = 0.0
                    elif Priority(req.priority) is Priority.CRITICAL and self.sched.policy.preempt:
                        wait = 0.0  # it would preempt its way in
                    else:
                        wait = (
                            (lane_backlog + queue_backlog - req.n_steps) * step_s / self.max_batch
                        )
                    action, tier = self.sched.deadline_action(
                        req, now, est_step_s=step_s, est_wait_s=wait, tiers=self.tiers
                    )
                    if action == "degrade":
                        self.sched.remove(req)
                        degrade.append((req, tier))
                    elif action == "reject":
                        self.sched.remove(req)
                        done.append(self._reject(req, now))
        if degrade:
            s0 = time.perf_counter()
            done.extend(self._serve_degraded(degrade, now))
            dt = time.perf_counter() - s0
            served_s += dt
            self.metrics.degrade_s += dt

        pol = self.sched.policy
        while pol.preempt and self.sched.has_class(Priority.CRITICAL) and self._free_lane() is None:
            victim = self._pick_victim()
            if victim is None:
                break
            req = self.sched.pop_class(Priority.CRITICAL)
            if req is None:
                break
            self._preempt(victim)
            self._admit(req, victim, now)

        while self.sched:
            slot = self._free_lane()
            if slot is None:
                break
            req = self.sched.pop()
            if req is None:
                break  # queue non-empty but nothing admissible: idle round
            self._admit(req, slot, now)

        self.metrics.dispatch_s += time.perf_counter() - t0 - served_s
        return done

    def _admit(self, req: SNNRequest, slot: int, now: float) -> None:
        """Place a request on a free lane: restore its snapshotted carry if
        it was preempted (the resume is then bit-exact), restore its
        stream's carry if it is a streaming chunk, else start a fresh lane."""
        if req._suspended is not None:
            lane, carry = req._suspended
            req._suspended = None
            lane_state_put(self._states, slot, carry)
            self._lanes[slot] = lane
            self.metrics.inc("resumed")
            return
        if req.admitted_seq is None:
            req.admitted_seq = self._admit_seq
            self._admit_seq += 1
        req.route = "event-pallas" if self._sparse_lane_eligible(req) else "lanes"
        lane = _Lane(req=req, admitted_wall=now, counts=np.zeros(self.net.n_classes, np.int64))
        if req._record_steps:
            lane.step_out = []
        if req._carry_in is not None:
            # a streaming chunk resumes its stream's carry: write the
            # snapshot over whatever the slot last held (fresh=False keeps
            # the reset flag off); carry0 keeps it on the host so that a
            # quarantine restarts this chunk from its own seam
            lane_state_put(self._states, slot, req._carry_in)
            lane.fresh = False
            lane.carry0 = req._carry_in
            req._carry_in = None
        self._lanes[slot] = lane

    def _pick_victim(self) -> int | None:
        """Preemption victim: the non-critical lane with the most window
        left, respecting the policy's per-request eviction cap."""
        pol = self.sched.policy
        best, best_rem = None, -1
        for i, lane in enumerate(self._lanes):
            if lane is None:
                continue
            r = lane.req
            if Priority(r.priority) is Priority.CRITICAL:
                continue
            rem = r.n_steps - lane.t
            if rem < pol.preempt_min_remaining_steps or r.preemptions >= pol.max_preemptions:
                continue
            if rem > best_rem:
                best, best_rem = i, rem
        return best

    def _preempt(self, slot: int) -> None:
        """Evict a running lane: snapshot its carry and re-enqueue the
        request at the front of its class queue."""
        lane = self._lanes[slot]
        self._lanes[slot] = None
        req = lane.req
        req.preemptions += 1
        req._suspended = (lane, lane_state_take(self._states, slot))
        self.sched.requeue_front(req)
        self.metrics.inc("preempted")

    def _serve_degraded(
        self, batch: list[tuple[SNNRequest, PrecisionTier]], now: float
    ) -> list[SNNRequest]:
        """Express service for deadline-degraded requests: one ragged
        ``run_int_batched`` per tier group (batch and window padded to powers
        of two; per-sample lengths keep each sample bit-exact)."""
        done: list[SNNRequest] = []
        groups: dict[str, tuple[PrecisionTier, list[SNNRequest]]] = {}
        for req, tier in batch:
            groups.setdefault(tier.name, (tier, []))[1].append(req)
        cap = 1 << max(0, (self.max_batch - 1)).bit_length()
        for tier, reqs in groups.values():
            for lo in range(0, len(reqs), cap):
                chunk = reqs[lo : lo + cap]
                steps = [tier.steps(r.n_steps) for r in chunk]
                T_pad = 1 << max(0, (max(steps) - 1)).bit_length()
                B_pad = min(cap, 1 << max(0, (len(chunk) - 1)).bit_length())
                x = np.zeros((T_pad, B_pad, self.net.n_in), np.int32)
                lengths = np.zeros((B_pad,), np.int32)
                for b, (r, Tb) in enumerate(zip(chunk, steps)):
                    x[:Tb, b] = r.raster[:Tb]
                    lengths[b] = Tb
                rec = run_int_batched(tier.net, tier.qparams, x, lengths)
                counts = rec.spike_counts.cpu().numpy()
                end = time.perf_counter()
                for b, (r, Tb) in enumerate(zip(chunk, steps)):
                    r.spike_counts = counts[b]
                    r.status = "degraded"
                    r.tier = tier.name
                    r.route = "degraded"
                    r.service_s = end - now
                    self._finish(r, end, stats_src=("batch", (rec, b, Tb)), net=tier.net)
                    done.append(r)
        return done

    # -- the tick loop ------------------------------------------------------
    def _chunk_cap(self) -> int:
        if self.tick_stride is None:
            return 1 << 30  # effectively uncapped
        return 1 << (self.tick_stride.bit_length() - 1)

    def _chunk_len(self, active: list[int]) -> int:
        """Power-of-two step count that just covers the earliest lane
        completion (capped by ``tick_stride``)."""
        k = min(self._lanes[i].req.n_steps - self._lanes[i].t for i in active)
        k = 1 << max(0, (k - 1)).bit_length()  # next power of two >= k
        return min(k, self._chunk_cap())

    def _advance(self, x: np.ndarray, meta: np.ndarray, ff_mode: str, budget) -> np.ndarray:
        """One lane-window call on the device; returns the packed host copy."""
        xt = torch.from_numpy(x).to(self.device)
        mt = torch.from_numpy(meta).to(self.device)
        packed = _lane_window_packed(self.net, self.qparams, self._states, xt, mt, ff_mode, budget)
        return packed.cpu().numpy()

    def tick(self) -> list[SNNRequest]:
        """One chunked advance for every active lane; returns finished."""
        active = [i for i, lane in enumerate(self._lanes) if lane is not None]
        if not active:
            return []
        if self.faults is not None:
            self.faults.on_tick()  # chaos: may stall, raise, or "kill"
        k = self._chunk_len(active)
        dtype = (
            np.uint8
            if all(self._lanes[i].req.raster.dtype == np.uint8 for i in active)
            else np.int32
        )
        x = np.zeros((k, self.max_batch, self.net.n_in), dtype)
        meta = np.zeros((2, self.max_batch), np.int32)  # (reset flags, valid steps)
        for i in active:
            lane = self._lanes[i]
            valid = min(k, lane.req.n_steps - lane.t)
            x[:valid, i] = lane.req.raster[lane.t : lane.t + valid]
            meta[1, i] = valid
            if lane.fresh:
                meta[0, i] = 1
                lane.fresh = False
        # The sparse chunk runs when every active lane honors the budget's
        # capacity + exactness contract; otherwise the dense chunk, still
        # bit-exact.
        budget = (
            self._event_budget
            if self._event_budget is not None
            and all(
                self._lanes[i].req._max_step_events <= self._event_budget
                and self._lanes[i].req._max_val <= self._sparse_val_max
                for i in active
            )
            else None
        )
        if budget is not None:
            ff_mode = "f32_exact" if self._deep_f32_ok else "int32"
        else:
            ff_mode = (
                "f32_exact"
                if self._f32_input_max >= 1
                and all(self._lanes[i].req._max_val <= self._f32_input_max for i in active)
                else "int32"
            )
        t0 = time.perf_counter()
        packed = self._advance(x, meta, ff_mode, budget)  # [k, n_lanes, n_classes + n_layers]
        tick_wall = time.perf_counter() - t0
        # which product the tick ran: "tick:sparse" (sparse_accum for layer
        # 0), "tick:f32_exact" or "tick:int32" (spike_matmul)
        self.metrics.inc("tick:sparse" if budget is not None else f"tick:{ff_mode}")
        n_classes = self.net.n_classes
        self.n_ticks += 1
        self.n_steps_run += k
        finished = []
        now = time.perf_counter()
        self.metrics.record_tick(k, tick_wall, len(self.sched), len(active), self.max_batch, now)
        ending = []
        for i in active:
            lane = self._lanes[i]
            valid = int(meta[1, i])
            lane.counts += packed[:, i, :n_classes].sum(axis=0)  # masked past valid
            lane.layer_events.append(packed[:valid, i, n_classes:])  # [valid, L]
            if lane.step_out is not None:
                lane.step_out.append(packed[:valid, i, :n_classes].copy())
            lane.t += valid
            if lane.t >= lane.req.n_steps:
                ending.append(i)
        # the freeze in batched_lane_window pinned each finished slot's carry
        # at its lane's boundary, so a snapshot now is the carry after the
        # request's last real step; every such carry comes back in one copy
        want = [i for i in ending if self._lanes[i].req._want_carry]
        carries = dict(zip(want, lane_states_take(self._states, want)))
        for i in ending:
            finished.append(self._complete_lane(i, now, carries.get(i)))
        if self.faults is not None:
            # chaos: corrupt a still-active lane's carry *after* the tick's
            # saturate ran (so the corruption survives until the validity
            # sweep, like a mid-window bit flip on real hardware)
            still = [i for i in active if self._lanes[i] is not None]
            self.faults.poison_carry(self._states, still)
        return finished

    def _complete_lane(self, slot: int, now: float, carry_out=None) -> SNNRequest:
        lane = self._lanes[slot]
        self._lanes[slot] = None  # freed immediately: next dispatch may reuse it
        req = lane.req
        req.carry_out = carry_out
        if lane.step_out is not None:
            req.step_outputs = (
                np.concatenate(lane.step_out, axis=0)
                if lane.step_out
                else np.zeros((0, self.net.n_classes), np.int64)
            )
        req.spike_counts = lane.counts
        req.service_s = now - lane.admitted_wall
        self._finish(req, now, stats_src=("chunks", lane.layer_events))
        return req

    def _finish(self, req: SNNRequest, now: float, stats_src: tuple, net=None) -> None:
        if req._finalized:
            raise RuntimeError(f"request {req.uid} reached a terminal state twice")
        req._finalized = True
        req._suspended = None
        if req.status is None:
            req.status = "completed"
            req.tier = "full"
        req.prediction = int(np.argmax(req.spike_counts))
        if req._arrival_wall is not None:
            req.latency_s = now - req._arrival_wall
        if req.service_s is None:
            req.service_s = req.latency_s
        if self.report_design_point:
            req._stats_src = stats_src
            req._net = net if net is not None else self.net
        self.n_served += 1
        self.metrics.record_finish(req, now)
        self._finalize(req)

    def _reject(self, req: SNNRequest, now: float) -> SNNRequest:
        """Terminal reject: the client learns now, not after a doomed wait."""
        if req._finalized:
            raise RuntimeError(f"request {req.uid} reached a terminal state twice")
        req._finalized = True
        req._suspended = None
        req.status = "rejected"
        if req._arrival_wall is not None:
            req.latency_s = now - req._arrival_wall
        self.metrics.record_reject(req, now)
        self._finalize(req)
        return req

    def _finalize(self, req: SNNRequest) -> None:
        """Invoke the completion callback; a raising callback is counted and
        contained -- it must never take the serving loop down."""
        # WAL: the terminal state lands before the callback runs, so a crash
        # inside a callback still replays as "served" (streaming chunks are
        # the manager's to journal)
        if self.journal is not None and not req._want_carry:
            self.journal.append("done", uid=req.uid, status=req.status)
        if req.on_complete is not None:
            try:
                req.on_complete(req)
            except Exception:
                self.metrics.inc("callback_failures")

    # -- NeurA-Guard: carry validity + lane quarantine -----------------------
    def sweep_carries(self) -> list[int]:
        """Validity sweep over the active lanes' device carries.

        A healthy carry is bounded by construction: every tick saturates
        ``u`` into the layer's ``u_bits`` range and ``i_syn`` into
        ``i_bits``, and ``prev_spk`` is binary.  Anything outside those
        bounds can only be corruption (a bit flip, an injected fault), and
        the lane's trajectory is no longer trustworthy.  Returns the active
        slots that fail, in slot order; the supervisor quarantines them.

        One bounds check over the whole pool on the device and one copy of
        the [max_batch] mask of bad slots (the JAX engine copies each active
        lane's carry to the host).  The pool is int32, so there is no
        finiteness to check.
        """
        active = [i for i, lane in enumerate(self._lanes) if lane is not None]
        if not active:
            return []
        bad = torch.zeros(self.max_batch, dtype=torch.bool, device=self.device)
        out = lambda a, lo, hi: ((a < lo) | (a > hi)).any(dim=1)
        for st, cfg in zip(self._states, self.net.layers):
            bad |= out(st.u, int_min(cfg.u_bits), int_max(cfg.u_bits))
            bad |= out(st.i_syn, int_min(cfg.i_bits), int_max(cfg.i_bits))
            bad |= out(st.prev_spk, 0, 1)
        mask = bad.cpu().numpy()
        return [i for i in active if mask[i]]

    def quarantine_lane(self, slot: int) -> SNNRequest | None:
        """Condemn a lane slot and salvage its request.

        The slot never admits again (only an engine restart reclaims it).
        The resident request restarts from its last trustworthy seam: a
        streaming chunk re-enters the queue with its chunk-start carry
        (``carry0``), anything else restarts from admission -- both
        bit-exact, because everything computed *on* the corrupt lane is
        discarded.  Returns the requeued request (``None`` for an
        already-empty slot).
        """
        if not 0 <= slot < self.max_batch:
            raise ValueError(f"no lane slot {slot}")
        self._quarantined.add(slot)
        lane = self._lanes[slot]
        self._lanes[slot] = None
        if lane is None:
            return None
        req = lane.req
        req.restarts += 1
        req._suspended = None
        req._carry_in = lane.carry0  # chunk-start seam (None = fresh restart)
        self.sched.requeue_front(req)
        self.metrics.inc("quarantined_lanes")
        self.metrics.inc("quarantine_restarts")
        return req

    def warmup(self, n_steps: int | None = None, include_int32: bool = False) -> None:
        """Build the kernels and run one tick per chunk length, so nothing is
        built or first-touched while requests are timed.

        Runs zero-validity chunks for every power-of-two chunk length up to
        the one covering ``n_steps`` (default: the network's window), for
        the dense route, the sparse lane route when enabled, and (with
        ``include_int32``) the int32 product; plus one direct event serve
        for an eager event strategy and one express batch per tier.  The
        pool, ``n_served`` and the metrics are reset on the way out.
        """
        if self.in_flight:
            raise RuntimeError("warmup() requires an idle engine")
        if self.device.type == "cuda":
            build.load_all()
        T = self.net.n_steps if n_steps is None else n_steps
        cap = self._chunk_cap()
        combos = [(np.uint8, "f32_exact" if self._f32_input_max >= 1 else "int32", None)]
        if self._event_budget is not None:
            combos.append(
                (np.uint8, "f32_exact" if self._deep_f32_ok else "int32", self._event_budget)
            )
        if include_int32:
            combos += [(np.uint8, "int32", None), (np.int32, "int32", None)]
        for dtype, ff_mode, budget in dict.fromkeys(combos):
            k = 1
            while True:
                kk = min(k, cap)
                x = np.zeros((kk, self.max_batch, self.net.n_in), dtype)
                meta = np.zeros((2, self.max_batch), np.int32)
                self._advance(x, meta, ff_mode, budget)
                if kk == cap or k >= T:
                    break
                k <<= 1
        # zero-validity chunks froze every carry, but reset the pool anyway
        for st in self._states:
            for a in st:
                a.zero_()
        if self.event_backend is not None and self._event_budget is None:
            self._serve_event(SNNRequest(uid=-1, raster=np.zeros((T, self.net.n_in), np.uint8)))
        for tier in self.tiers:
            T_pad = 1 << max(0, (tier.steps(T) - 1)).bit_length()
            run_int_batched(
                tier.net,
                tier.qparams,
                np.zeros((T_pad, 1, self.net.n_in), np.int32),
                np.zeros((1,), np.int32),
            ).spike_counts.cpu()
        self.n_served = 0
        self.metrics = ServeMetrics(self.metrics.window_s)

    # -- serve loops --------------------------------------------------------
    def poll(self) -> list[SNNRequest]:
        """One service round: a dispatch round, then one tick (with the
        ``max_idle_ticks`` liveness guard)."""
        done = self._dispatch(time.perf_counter())
        done.extend(self.tick())
        if done or self.active_lanes > 0 or not self.sched:
            self._idle_rounds = 0
        else:
            self._idle_rounds += 1
            if self.max_idle_ticks is not None and self._idle_rounds >= self.max_idle_ticks:
                snap = self.sched.snapshot()
                lanes = [
                    None
                    if lane is None
                    else {"uid": lane.req.uid, "t": lane.t, "n_steps": lane.req.n_steps}
                    for lane in self._lanes
                ]
                raise EngineStalledError(
                    f"no progress for {self._idle_rounds} consecutive rounds "
                    f"with {len(self.sched)} queued request(s) and no active "
                    f"lanes; queue snapshot: {snap}; lanes: {lanes}",
                    snap,
                    lanes,
                )
        return done

    def drain(self) -> list[SNNRequest]:
        """Serve everything already submitted to completion."""
        done = []
        while self.in_flight:
            done.extend(self.poll())
        return done

    def run(self, requests: Sequence[SNNRequest]) -> list[SNNRequest]:
        """Open-loop offered-load replay: requests become visible when the
        wall clock passes their ``arrival_s`` offset from the call's start."""
        pending = sorted(requests, key=lambda r: r.arrival_s)
        t0 = time.perf_counter()
        for req in pending:
            req._arrival_wall = t0 + req.arrival_s
        done: list[SNNRequest] = []
        i = 0
        while i < len(pending) or self.in_flight:
            now = time.perf_counter()
            while i < len(pending) and pending[i]._arrival_wall <= now:
                self.submit(pending[i])
                i += 1
            if self.in_flight:
                done.extend(self.poll())
            elif i < len(pending):
                time.sleep(max(0.0, pending[i]._arrival_wall - now))
        return done


def _on(p, device: torch.device) -> IntLayerParams:
    return IntLayerParams(*(torch.as_tensor(a).to(device) for a in p))


class AsyncSNNServer:
    """asyncio facade over :class:`SNNServeEngine`.

    ``submit`` returns a future resolved with the request at any terminal
    state; one background task drives the engine's poll loop while anything
    is in flight.  If the engine raises mid-drive every pending future
    receives the exception (also kept on ``server.error``).
    """

    def __init__(self, engine: SNNServeEngine):
        self.engine = engine
        self._futures: dict[int, asyncio.Future] = {}
        self._task: asyncio.Task | None = None
        self.error: BaseException | None = None

    def submit(self, req: SNNRequest) -> "asyncio.Future[SNNRequest]":
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._futures[id(req)] = fut
        try:
            self.engine.submit(req)
        except Exception:
            self._futures.pop(id(req), None)
            raise
        if self._task is None or self._task.done():
            self._task = loop.create_task(self._drive())
        return fut

    async def serve(self, requests: Sequence[SNNRequest]) -> list[SNNRequest]:
        return list(await asyncio.gather(*[self.submit(r) for r in requests]))

    async def _drive(self) -> None:
        try:
            while self.engine.in_flight:
                for req in self.engine.poll():
                    fut = self._futures.pop(id(req), None)
                    if fut is not None and not fut.done():
                        fut.set_result(req)
                await asyncio.sleep(0)
        except Exception as e:
            # deliver the failure to every waiter rather than hanging them
            self.error = e
            pending, self._futures = self._futures, {}
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(e)
