"""NeurA-Serve front-line scheduling: priorities, fairness, QoS tiers.

The iteration-level half of the serving engine's control plane.  The
engine (``repro_torch.serve.snn_engine``) owns the *lanes* -- device-resident
carry state advanced by one jitted chunk per tick -- and this module owns
the *queue*: which waiting request gets the next free lane, which tenant's
turn it is, and what to do with a request whose deadline cannot survive
the queue.

Three mechanisms compose (the aphrodite-style engine/scheduler split,
specialised to the paper's accuracy-vs-resource trade):

* **Priority classes with weighted sharing.**  :class:`Priority` orders
  requests into ``CRITICAL`` / ``STANDARD`` / ``BEST_EFFORT`` classes.
  Admission runs deficit-round-robin over the classes with
  ``SchedPolicy.class_weights`` credits per cycle, so critical traffic
  dominates under contention while the lowest class still receives a
  guaranteed share each cycle -- *prioritised but starvation-free* (the
  property suite asserts both).  Within a class, per-tenant queues are
  served weighted-fair (virtual-time WFQ, cost = the request's step
  count) and each tenant's own queue is strict FIFO.

* **Deadline-aware degradation.**  A request carrying ``deadline_s`` is
  never left to queue past its SLO.  When the engine's service estimate
  says the deadline will be missed, the scheduler's verdict
  (:meth:`Scheduler.deadline_action`) is to *degrade* -- re-serve the
  request immediately at a coarser registered :class:`PrecisionTier`
  (lower ``w_bits`` and/or a truncated window: exactly the accuracy-for-
  resources dial Flexi-NeurA's Flex-plorer explores, applied online) --
  or, when no registered tier can make the deadline either, to *reject*
  up front.  Rejecting early is a QoS feature: the client learns *now*
  instead of waiting out a doomed queue.

* **Preemption.**  A queued ``CRITICAL`` request may evict a running
  lower-priority lane (longest remaining window first).  The evicted
  lane's carry state is snapshotted through the engine's existing lane
  seams and the request re-enters the *front* of its class queue, so a
  resumed request completes bit-exactly as if it had never been paused.

The scheduler is pure host-side bookkeeping -- no jax, no device state --
so every decision is unit-testable without touching the lane pool.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from collections import deque
from typing import TYPE_CHECKING, Mapping, Sequence

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (engine imports us)
    from repro_torch.serve.snn_engine import SNNRequest

__all__ = ["Priority", "SchedPolicy", "PrecisionTier", "Scheduler"]


class Priority(enum.IntEnum):
    """Request priority class; lower value = more urgent.

    ``STREAMING`` is the persistent-session traffic class
    (``repro_torch.serve.streaming``): a stream's chunk requests are continuous
    background work -- below the interactive classes in strict order, but
    with their own DRR credit line (default weight above BEST_EFFORT's), so
    open sessions keep advancing under interactive overload instead of
    starving behind it.
    """

    CRITICAL = 0  # latency-critical (wearable / prosthetic control loops)
    STANDARD = 1
    BEST_EFFORT = 2
    STREAMING = 3  # persistent-session chunk traffic (repro_torch.serve.streaming)


@dataclasses.dataclass(frozen=True)
class SchedPolicy:
    """Scheduling policy knobs (all host-side, hot-swappable per engine).

    ``class_weights``
        Admission credits per deficit-round-robin cycle for
        (CRITICAL, STANDARD, BEST_EFFORT, STREAMING).  All must be >= 1:
        a zero weight would starve that class outright, which the
        scheduler explicitly guarantees against.  A legacy 3-tuple (the
        pre-streaming interactive classes) is accepted and extended with
        the default STREAMING weight.
    ``tenant_weights``
        Per-tenant WFQ weight within a class (default 1.0).  A tenant
        with weight 2 receives ~2x the admitted *work* (step count, not
        request count) of a weight-1 tenant under backlog.
    ``preempt`` / ``preempt_min_remaining_steps`` / ``max_preemptions``
        Whether a queued CRITICAL request may evict a running
        lower-priority lane; lanes within ``preempt_min_remaining_steps``
        of completing are never worth evicting, and a single request is
        never evicted more than ``max_preemptions`` times.
    ``deadline_safety``
        Multiplier on the service-time estimate used in deadline
        decisions (> 1 = degrade earlier, more conservatively).
    """

    class_weights: tuple[int, ...] = (8, 3, 1, 2)
    tenant_weights: Mapping[str, float] | None = None
    preempt: bool = True
    preempt_min_remaining_steps: int = 4
    max_preemptions: int = 4
    deadline_safety: float = 1.0

    def __post_init__(self):
        if len(self.class_weights) == len(Priority) - 1:
            # legacy 3-class weights: extend with the default STREAMING credit
            object.__setattr__(
                self, "class_weights", tuple(self.class_weights) + (2,)
            )
        if len(self.class_weights) != len(Priority):
            raise ValueError(
                f"class_weights needs one weight per class, got {self.class_weights}"
            )
        if any(w < 1 for w in self.class_weights):
            raise ValueError(
                f"class_weights must all be >= 1 (0 starves a class): {self.class_weights}"
            )
        if self.deadline_safety <= 0:
            raise ValueError(f"deadline_safety must be > 0, got {self.deadline_safety}")
        if self.tenant_weights is not None and any(
            w <= 0 for w in self.tenant_weights.values()
        ):
            raise ValueError("tenant_weights must all be > 0")

    def tenant_weight(self, tenant: str) -> float:
        if self.tenant_weights is None:
            return 1.0
        return float(self.tenant_weights.get(tenant, 1.0))


@dataclasses.dataclass(frozen=True)
class PrecisionTier:
    """One registered degradation target: a coarser deployment precision.

    ``net``/``qparams`` are a re-quantization of the *same* float weights
    at coarser bit-widths (same layer shapes -- only the quantization grid
    moves), and ``steps_fraction`` optionally truncates the inference
    window (temporal precision: fewer rate-code steps).  A degraded
    request is served through one immediate ragged ``run_int_batched``
    call at this tier -- bit-exact with a serial ``run_int`` at the same
    tier, which is what the serving tests assert.
    """

    name: str
    net: object  # NetworkConfig (kept untyped: scheduler stays jax-free)
    qparams: tuple
    steps_fraction: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.steps_fraction <= 1.0:
            raise ValueError(
                f"steps_fraction must be in (0, 1], got {self.steps_fraction}"
            )
        object.__setattr__(self, "qparams", tuple(self.qparams))

    def steps(self, n_steps: int) -> int:
        """Window length this tier serves for a full window of ``n_steps``."""
        return max(1, math.ceil(n_steps * self.steps_fraction))

    @staticmethod
    def from_params(
        net, params, *, w_bits: int, steps_fraction: float = 1.0, name: str | None = None
    ) -> "PrecisionTier":
        """Build a tier by re-quantizing float ``params`` at ``w_bits``."""
        from repro_torch.core.network import quantize_params

        coarse = net.replace_precisions(w_bits=w_bits)
        qparams, _ = quantize_params(coarse, params)
        if name is None:
            name = f"w{w_bits}"
            if steps_fraction < 1.0:
                name += f"-t{steps_fraction:g}"
        return PrecisionTier(
            name=name, net=coarse, qparams=tuple(qparams), steps_fraction=steps_fraction
        )


class Scheduler:
    """Priority + tenant-fair queue with deadline verdicts.

    Pure bookkeeping over :class:`~repro_torch.serve.snn_engine.SNNRequest`
    objects; the engine asks it three questions each dispatch round:
    ``pop()`` (who gets the next free lane), ``pop_class(CRITICAL)``
    (who rides a preempted lane), and ``deadline_action(...)`` (keep /
    degrade / reject a deadlined request).  It also quacks enough like
    the plain FIFO ``deque`` it replaced (``len`` / ``bool`` / indexing /
    iteration in scheduling order) that callers of the old
    ``engine.queue`` keep working.
    """

    def __init__(self, policy: SchedPolicy | None = None):
        self.policy = policy if policy is not None else SchedPolicy()
        # class -> tenant -> FIFO of requests
        self._queues: dict[Priority, dict[str, deque]] = {
            cls: {} for cls in Priority
        }
        self._credits: dict[Priority, int] = {
            cls: self.policy.class_weights[cls] for cls in Priority
        }
        self._vtime: dict[tuple[Priority, str], float] = {}
        self._seq = itertools.count()

    # -- container protocol (the engine's ``queue`` facade) -----------------
    def __len__(self) -> int:
        return sum(
            len(q) for tenants in self._queues.values() for q in tenants.values()
        )

    def __bool__(self) -> bool:
        return any(q for tenants in self._queues.values() for q in tenants.values())

    def __iter__(self):
        """Scheduling-order iteration: class-major, submit order within."""
        for cls in Priority:
            reqs = [r for q in self._queues[cls].values() for r in q]
            reqs.sort(key=lambda r: r._sched_seq)
            yield from reqs

    def __getitem__(self, i):
        return list(self)[i]

    # -- queue ops -----------------------------------------------------------
    def add(self, req: "SNNRequest") -> None:
        cls = Priority(req.priority)
        if getattr(req, "_sched_seq", None) is None:
            req._sched_seq = next(self._seq)
        q = self._queues[cls].setdefault(req.tenant, deque())
        if not q:
            # a tenant (re)activating joins at the current virtual time, so
            # idling never banks credit against active tenants
            floor = max(
                (
                    self._vtime.get((cls, t), 0.0)
                    for t, tq in self._queues[cls].items()
                    if tq
                ),
                default=0.0,
            )
            key = (cls, req.tenant)
            self._vtime[key] = max(self._vtime.get(key, 0.0), floor)
        q.append(req)

    def requeue_front(self, req: "SNNRequest") -> None:
        """Re-enqueue a preempted request at the *front* of its queue, so a
        resumed request keeps its original FIFO position in its class."""
        cls = Priority(req.priority)
        self._queues[cls].setdefault(req.tenant, deque()).appendleft(req)

    def remove(self, req: "SNNRequest") -> bool:
        """Drop a queued request (deadline sweep / direct-route serve)."""
        q = self._queues[Priority(req.priority)].get(req.tenant)
        if q is not None:
            try:
                q.remove(req)
                return True
            except ValueError:
                pass
        return False

    def has_class(self, cls: Priority) -> bool:
        return any(self._queues[Priority(cls)].values())

    def _pop_tenant(self, cls: Priority) -> "SNNRequest":
        """WFQ pick within a class: the non-empty tenant with the smallest
        virtual time; its vtime advances by the request's work over its
        weight, so heavier tenants progress proportionally more."""
        tenant = min(
            (t for t, q in self._queues[cls].items() if q),
            key=lambda t: (self._vtime.get((cls, t), 0.0), t),
        )
        req = self._queues[cls][tenant].popleft()
        cost = max(1, req.n_steps)
        self._vtime[(cls, tenant)] = self._vtime.get((cls, tenant), 0.0) + (
            cost / self.policy.tenant_weight(tenant)
        )
        return req

    def pop(self) -> "SNNRequest | None":
        """Next request by class-credit deficit-round-robin + tenant WFQ."""
        nonempty = [cls for cls in Priority if self.has_class(cls)]
        if not nonempty:
            return None
        eligible = [cls for cls in nonempty if self._credits[cls] > 0]
        if not eligible:
            # cycle boundary: every backlogged class spent its credits --
            # refill all, which is what makes the lowest class starvation-free
            for cls in Priority:
                self._credits[cls] = self.policy.class_weights[cls]
            eligible = nonempty
        cls = min(eligible)
        self._credits[cls] -= 1
        return self._pop_tenant(cls)

    def pop_class(self, cls: Priority) -> "SNNRequest | None":
        """Pop the next request of one class (the preemption admit path).
        Spends that class's credit so preempted admissions still count
        against its share."""
        cls = Priority(cls)
        if not self.has_class(cls):
            return None
        if self._credits[cls] > 0:
            self._credits[cls] -= 1
        return self._pop_tenant(cls)

    # -- deadline verdicts ---------------------------------------------------
    def deadline_action(
        self,
        req: "SNNRequest",
        now: float,
        *,
        est_step_s: float | None,
        est_wait_s: float,
        tiers: Sequence[PrecisionTier],
    ) -> tuple[str, PrecisionTier | None]:
        """Keep / degrade / reject a deadlined request, given the engine's
        current service estimate.

        ``est_step_s`` is the engine's measured wall seconds per simulated
        step (``None`` before any tick has been observed: the verdict is
        then optimistic -- only an already-expired deadline acts).
        ``est_wait_s`` is the engine's queueing-delay estimate for this
        request (0 for a request that would preempt its way in).

        Returns ``("keep", None)``, ``("degrade", tier)`` (first -- i.e.
        finest -- registered tier whose *immediate* degraded service still
        makes the deadline; degraded serves skip the queue), or
        ``("reject", None)`` when nothing registered can make it.
        """
        deadline = req._arrival_wall + req.deadline_s
        step = (est_step_s or 0.0) * self.policy.deadline_safety
        if now + est_wait_s + req.n_steps * step <= deadline:
            return ("keep", None)
        for tier in tiers:
            if now + tier.steps(req.n_steps) * step <= deadline:
                return ("degrade", tier)
        return ("reject", None)

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        """Queue state for diagnostics (the engine's stall error embeds it)."""
        return {
            "depth": len(self),
            "credits": {cls.name: self._credits[cls] for cls in Priority},
            "classes": {
                cls.name: {
                    tenant: [r.uid for r in q]
                    for tenant, q in self._queues[cls].items()
                    if q
                }
                for cls in Priority
                if self.has_class(cls)
            },
        }
