"""NeurA-Guard fault injection: every serving failure mode, reproducibly.

Port of ``repro/serve/faults.py`` (numpy only).  The one device-side
difference: ``poison_carry`` adds its corruption to the lane pool's
membrane tensor in place, on the pool's own device, where the JAX version
returns a functionally updated pool.  ``FaultInjector.from_seed`` draws
from the same numpy stream, so a seed gives JAX's schedule.

Crash-safety code is only as trustworthy as the crashes it has survived,
and real crashes are not repeatable.  This module makes them so: a
:class:`FaultInjector` is threaded through the serving engine
(``SNNServeEngine(faults=...)``), the checkpoint store
(``Checkpointer(faults=...)``), and the write-ahead journal
(``Journal(faults=...)``), and fires *armed* faults at exact, counted
hook sites -- so a chaos test can say "the 3rd tick raises, the 5th tick
poisons lane 1's carry, the 2nd checkpoint write tears halfway" and get
that exact failure schedule on every run.

Fault sites (one counter each; a fault arms at a 0-based arrival index):

``tick``
    Raise :class:`InjectedFault` at the top of the engine's jitted chunk
    advance -- a transient per-tick failure the supervisor must retry.
``slow_tick``
    Sleep ``sleep_s`` inside the tick -- a stall the supervisor's
    slow-tick watchdog must notice without any exception being raised.
``carry``
    Corrupt one active lane's membrane carry *after* the tick's outputs
    were read (add ``1 << bit``, pushing it outside the layer's
    ``u_bits`` saturation range) -- the poisoned-lane case the
    supervisor's validity sweep must quarantine.
``checkpoint``
    Raise :class:`SimulatedKill` between the checkpoint commit's file
    writes -- a torn write that the atomic write-tmp -> fsync -> rename
    protocol must render invisible to readers.
``journal``
    Write only the first half of the next journal frame, then raise
    :class:`SimulatedKill` -- a torn append that journal replay must
    truncate at the last whole record.
``kill``
    Raise :class:`SimulatedKill` at the top of the tick -- a process
    death; recovery must come from the journal + checkpoints alone.

:class:`SimulatedKill` deliberately subclasses ``BaseException``: the
serving stack contains several ``except Exception`` containment nets
(callback isolation, the HTTP 500 handler) that a real ``kill -9`` would
not be stopped by, so the simulated one must not be either.

``FaultInjector.from_seed`` derives a deterministic multi-fault schedule
from one integer -- the chaos soak's churn generator: same seed, same
faults, same tick indices, every run.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter

import numpy as np

__all__ = [
    "FaultSpec",
    "FaultInjector",
    "InjectedFault",
    "SimulatedKill",
    "SITES",
]

SITES = ("tick", "slow_tick", "carry", "checkpoint", "journal", "kill")


class InjectedFault(RuntimeError):
    """A deliberately injected, *recoverable* failure (e.g. a tick raise).
    Supervisors treat it like any transient exception: retry, then
    escalate."""


class SimulatedKill(BaseException):
    """A deliberately injected process death.

    Subclasses ``BaseException`` so the serving stack's ``except
    Exception`` containment (callback isolation, HTTP 500 translation)
    cannot swallow it -- exactly like a real SIGKILL, only the journal
    and the checkpoints survive it.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: fire on the ``at``-th arrival at ``site``.

    ``lane`` picks the carry-corruption victim (``None`` = first active
    lane at fire time); ``bit`` is the membrane bit the corruption adds;
    ``sleep_s`` is the ``slow_tick`` stall duration; ``every`` repeats
    the fault each ``every`` arrivals after ``at`` (``None`` = once).
    """

    site: str
    at: int
    lane: int | None = None
    bit: int = 26
    sleep_s: float = 0.05
    every: int | None = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; expected one of {SITES}")
        if self.at < 0:
            raise ValueError(f"fault index must be >= 0, got {self.at}")
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1 or None, got {self.every}")

    def fires_at(self, n: int) -> bool:
        if self.every is None:
            return n == self.at
        return n >= self.at and (n - self.at) % self.every == 0


class FaultInjector:
    """Deterministic fault scheduler: counted hook sites + armed specs.

    Hook methods are no-ops unless a spec fires, so production code can
    call them unconditionally behind an ``is not None`` guard.  Every
    fired fault is appended to ``self.fired`` (``(site, arrival_index)``
    plus the spec) -- the chaos tests' ground truth for *what* was
    injected.
    """

    def __init__(self, specs: "list[FaultSpec] | tuple[FaultSpec, ...]" = ()):
        self.specs = list(specs)
        self.counts: Counter = Counter()
        self.fired: list[tuple[str, int, FaultSpec]] = []

    def arm(self, site: str, at: int, **params) -> "FaultInjector":
        """Arm one fault; chainable (``inj.arm(...).arm(...)``)."""
        self.specs.append(FaultSpec(site=site, at=at, **params))
        return self

    @classmethod
    def from_seed(
        cls,
        seed: int,
        *,
        n_faults: int = 4,
        horizon: int = 32,
        sites: tuple[str, ...] = ("tick", "carry", "kill"),
    ) -> "FaultInjector":
        """A deterministic random schedule: ``n_faults`` faults drawn over
        the first ``horizon`` arrivals of the given sites.  Same seed =>
        same schedule, which is what makes the chaos soak replayable."""
        rng = np.random.default_rng(seed)
        inj = cls()
        for _ in range(n_faults):
            site = sites[int(rng.integers(len(sites)))]
            inj.arm(site, int(rng.integers(horizon)))
        return inj

    # -- the counting core ---------------------------------------------------
    def _fire(self, site: str) -> FaultSpec | None:
        n = self.counts[site]
        self.counts[site] += 1
        for spec in self.specs:
            if spec.site == site and spec.fires_at(n):
                self.fired.append((site, n, spec))
                return spec
        return None

    # -- engine hooks --------------------------------------------------------
    def on_tick(self) -> None:
        """Called at the top of every engine tick.  May stall (slow_tick),
        raise :class:`InjectedFault` (tick) or :class:`SimulatedKill`."""
        spec = self._fire("slow_tick")
        if spec is not None:
            time.sleep(spec.sleep_s)
        if self._fire("kill") is not None:
            raise SimulatedKill("injected: process killed mid-tick")
        spec = self._fire("tick")
        if spec is not None:
            raise InjectedFault(f"injected: tick failure (arrival {self.counts['tick'] - 1})")

    def poison_carry(self, states: list, active: list[int]) -> tuple[list, int | None]:
        """Called after the tick's outputs were read: maybe corrupt one
        active lane's layer-0 membrane carry (add ``1 << bit`` in place,
        pushing it past the ``u_bits`` saturation range the validity
        sweep checks).  Returns ``(states, poisoned_lane | None)``."""
        spec = self._fire("carry")
        if spec is None or not active:
            return states, None
        lane = spec.lane if spec.lane is not None and spec.lane in active else active[0]
        states[0].u[lane] += 1 << spec.bit
        return states, lane

    # -- durability hooks ----------------------------------------------------
    def on_checkpoint_write(self) -> None:
        """Called between a checkpoint commit's file writes: a fire here
        is a torn write (the process died with some files flushed and
        some not)."""
        if self._fire("checkpoint") is not None:
            raise SimulatedKill("injected: process killed mid-checkpoint-write")

    def torn_journal_bytes(self, frame: bytes) -> bytes | None:
        """Called by the journal before appending ``frame``: a fire
        returns the torn prefix to write instead (the caller writes it,
        flushes, and raises :class:`SimulatedKill`)."""
        if self._fire("journal") is not None:
            return frame[: max(1, len(frame) // 2)]
        return None
