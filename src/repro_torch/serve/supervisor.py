"""NeurA-Guard engine supervisor: retry, quarantine, restart, recover.

Port of ``repro/serve/supervisor.py`` (host Python, unchanged in policy).
On a device a restart builds a fresh lane pool: the dead engine's pool is
released (its ``_states`` dropped), and whatever is salvaged from it
crosses only through host snapshots -- preemption snapshots, chunk-start
carries (``_Lane.carry0``), the journal and the checkpoints.

:class:`SupervisedEngine` wraps the serve loop
(:class:`~repro_torch.serve.snn_engine.SNNServeEngine`, optionally under a
:class:`~repro_torch.serve.streaming.StreamSessionManager`) with the failure
policy the bare engine deliberately does not have:

* **Per-tick failures** (any ``Exception`` out of ``poll()``) are retried
  with bounded exponential backoff -- transient faults (an injected tick
  raise, a flaky driver) cost retries, not requests.  Exhausted retries
  escalate to a **warm restart**: a fresh engine is built, and every
  queued and in-flight request is salvaged from the old engine's host
  bookkeeping -- queued requests keep their preemption snapshots, active
  lanes restart from their chunk-start carry seam (``_Lane.carry0``) --
  so the *request objects* (and their completion callbacks) survive.
* **Poisoned carries**: every ``sweep_every`` polls the supervisor runs
  the engine's validity sweep (``sweep_carries`` -- int-range + binary +
  finiteness bounds that a healthy tick's saturation guarantees by
  construction) and **quarantines** failing lanes: the slot is condemned
  for the engine's lifetime and its request restarts from its last
  trustworthy seam.  A fully-condemned pool escalates to a warm restart,
  which reclaims the slots.
* **Process death** (:class:`~repro_torch.serve.faults.SimulatedKill` -- a
  ``BaseException``, so no containment net below us can swallow it)
  escalates to a **cold restart**: the journal is reopened (repairing
  any torn tail), a fresh engine + session manager are built, and
  :func:`repro_torch.serve.journal.recover` replays the WAL -- outstanding
  requests resubmit from admission, live sessions restore from their
  latest checkpoint and re-feed the journaled suffix.  Completion
  callbacks from the dead process are gone (they lived in its memory);
  the HTTP layer answers 503 + ``Retry-After`` while this runs.
* **Slow ticks**: polls slower than ``slow_tick_s`` are counted
  (``slow_ticks``) -- the watchdog signal for stalls that raise nothing.
* :class:`~repro_torch.serve.snn_engine.EngineStalledError` passes through
  untouched: a wedged scheduler is a capacity/config problem; restarting
  into the same queue would hide it.

One in-process simulation caveat, on purpose: a cold restart transplants
the metrics object (so ``neura_recovery_*`` counters and latency windows
survive), where a real process death would start metrics from zero.
Everything *stateful* -- queues, lanes, sessions, carries -- is rebuilt
from the journal and checkpoints alone, which is what the chaos battery
verifies bit-exactly.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Callable

from repro_torch.serve.faults import SimulatedKill
from repro_torch.serve.journal import Journal, recover
from repro_torch.serve.snn_engine import EngineStalledError, SNNServeEngine

if TYPE_CHECKING:  # pragma: no cover
    import pathlib

    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.streaming import StreamSessionManager

__all__ = ["SupervisedEngine"]


class SupervisedEngine:
    """Failure-policy wrapper around an engine (+ optional session manager).

    ``engine_factory`` builds a *bare* engine (no journal/faults wired --
    the supervisor owns those and attaches them, including across
    restarts).  ``manager_factory(engine)`` builds the session manager
    over a given engine; it must configure the same ``checkpoint_dir``
    the supervisor is given, or session recovery cannot find the carries.
    Drive it exactly like the engine: ``poll()`` / ``drain()`` /
    ``submit()``; ``status()`` is the ``/healthz`` payload fragment.
    """

    def __init__(
        self,
        engine_factory: "Callable[[], SNNServeEngine]",
        *,
        journal_dir: "str | pathlib.Path | None" = None,
        checkpoint_dir: "str | pathlib.Path | None" = None,
        manager_factory: "Callable[[SNNServeEngine], StreamSessionManager] | None" = None,
        faults: "FaultInjector | None" = None,
        max_tick_retries: int = 3,
        backoff_s: float = 0.005,
        backoff_factor: float = 2.0,
        sweep_every: int = 1,
        slow_tick_s: float | None = None,
        journal_fsync_every: int = 16,
    ):
        if max_tick_retries < 0:
            raise ValueError(f"max_tick_retries must be >= 0, got {max_tick_retries}")
        if sweep_every < 0:
            raise ValueError(f"sweep_every must be >= 0 (0 disables), got {sweep_every}")
        self.engine_factory = engine_factory
        self.manager_factory = manager_factory
        self.journal_dir = journal_dir
        self.checkpoint_dir = checkpoint_dir
        self.faults = faults
        self.max_tick_retries = max_tick_retries
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor
        self.sweep_every = sweep_every
        self.slow_tick_s = slow_tick_s
        self.journal_fsync_every = journal_fsync_every
        self.journal: Journal | None = (
            Journal(journal_dir, fsync_every=journal_fsync_every, faults=faults)
            if journal_dir is not None
            else None
        )
        self.engine = engine_factory()
        self._wire(self.engine)
        self.manager = manager_factory(self.engine) if manager_factory else None
        self.recovering = False
        self.retry_after_s = 1.0  # advertised via healthz 503 while recovering
        self.last_recovery: dict | None = None
        self._polls = 0

    def _wire(self, engine: SNNServeEngine) -> None:
        engine.journal = self.journal
        engine.faults = self.faults

    def _replace(self, old: SNNServeEngine, new: SNNServeEngine) -> None:
        """Make ``new`` the served engine and release ``old``'s lane pool:
        nothing of the dead engine's device state may be reused."""
        self._wire(new)
        self.engine = new
        if new is not old:
            old._states = None

    # -- passthroughs --------------------------------------------------------
    @property
    def metrics(self):
        return self.engine.metrics

    @property
    def in_flight(self) -> bool:
        busy = self.engine.in_flight
        if self.manager is not None:
            busy = busy or any(
                s.state == "live" and not s.drained
                for s in self.manager.sessions.values()
            )
        return busy

    def submit(self, req) -> None:
        self.engine.submit(req)

    # -- the supervised drive loop -------------------------------------------
    def _poll_once(self) -> list:
        if self.manager is not None:
            return self.manager.poll()
        return self.engine.poll() if self.engine.in_flight else []

    def poll(self) -> list:
        """One supervised service round.

        Failure ladder: retry with backoff -> warm restart (salvage host
        state) -> and, for a simulated process death, cold restart from
        the journal.  A restart round returns ``[]``; the salvaged /
        recovered requests complete on later polls.
        """
        self._polls += 1
        try:
            t0 = time.perf_counter()
            done = self._poll_once()
            if (
                self.slow_tick_s is not None
                and time.perf_counter() - t0 > self.slow_tick_s
            ):
                self.metrics.inc("slow_ticks")
            if self.sweep_every and self._polls % self.sweep_every == 0:
                self._sweep()
            return done
        except SimulatedKill:
            self._cold_restart()
            return []
        except EngineStalledError:
            raise
        except Exception:
            return self._retry_then_warm()

    def _retry_then_warm(self) -> list:
        delay = self.backoff_s
        for _ in range(self.max_tick_retries):
            time.sleep(delay)
            delay *= self.backoff_factor
            self.metrics.inc("tick_retries")
            try:
                return self._poll_once()
            except SimulatedKill:
                self._cold_restart()
                return []
            except EngineStalledError:
                raise
            except Exception:
                continue
        self._warm_restart()
        return []

    def drain(self, max_polls: int = 1_000_000) -> list:
        """Serve everything in flight to completion, surviving faults."""
        done = []
        for _ in range(max_polls):
            if not self.in_flight:
                return done
            done.extend(self.poll())
        raise RuntimeError(f"supervised drain did not converge in {max_polls} polls")

    # -- quarantine ----------------------------------------------------------
    def _sweep(self) -> None:
        bad = self.engine.sweep_carries()
        for slot in bad:
            self.engine.quarantine_lane(slot)
        if bad and self.engine.capacity == 0:
            # every slot condemned: the engine can never admit again --
            # rebuild it (host state is intact, so this is a warm restart)
            self._warm_restart()

    # -- restarts ------------------------------------------------------------
    def _warm_restart(self) -> None:
        """Rebuild the engine; salvage every request from host bookkeeping.

        Queued requests move over untouched (preemption snapshots are host
        arrays, still valid).  Active lanes lose their partial compute and
        restart from their chunk-start seam -- bit-exact, because nothing
        computed on the possibly-wrong engine state is kept.
        """
        t0 = time.perf_counter()
        self.recovering = True
        old = self.engine
        old.metrics.recovering = 1
        salvaged = []
        for lane in old._lanes:
            if lane is None:
                continue
            req = lane.req
            req.restarts += 1
            req._suspended = None
            req._carry_in = lane.carry0
            salvaged.append(req)
        queued = list(old.sched)
        new = self.engine_factory()
        new.metrics = old.metrics
        self._replace(old, new)
        if self.manager is not None:
            self.manager.engine = new  # sessions / chunk maps carry over
        for req in salvaged + queued:
            new.submit(req)
        dt = time.perf_counter() - t0
        m = new.metrics
        m.inc("recoveries_warm")
        m.recovery_s += dt
        m.recovering = 0
        self.last_recovery = {
            "kind": "warm",
            "duration_s": dt,
            "requests_salvaged": len(salvaged) + len(queued),
        }
        self.recovering = False

    def _cold_restart(self) -> None:
        """Simulated process death: rebuild everything from disk.

        The old engine/manager/journal handle are abandoned exactly as a
        killed process abandons its memory; the reopened journal repairs
        any torn tail, and :func:`repro_torch.serve.journal.recover` replays it
        (+ the checkpoint store) into a fresh engine and manager.
        """
        t0 = time.perf_counter()
        self.recovering = True
        old_metrics = self.engine.metrics
        old_metrics.recovering = 1
        if self.journal is not None:
            try:
                self.journal.close()
            except Exception:
                pass  # the dead process's handle; its state is on disk
            self.journal = Journal(
                self.journal_dir,
                fsync_every=self.journal_fsync_every,
                faults=self.faults,
            )
        new = self.engine_factory()
        new.metrics = old_metrics  # in-process simulation keeps observability
        self._replace(self.engine, new)
        self.manager = (
            self.manager_factory(new) if self.manager_factory is not None else None
        )
        summary = {"requests_resubmitted": 0, "sessions_reopened": 0}
        if self.journal_dir is not None:
            recovered = recover(self.journal_dir, self.checkpoint_dir)
            summary = recovered.apply(new, self.manager)
        dt = time.perf_counter() - t0
        m = new.metrics
        m.inc("recoveries_cold")
        m.inc("requests_resubmitted", summary.get("requests_resubmitted", 0))
        m.inc("journal_records_replayed", summary.get("records_replayed", 0))
        m.recovery_s += dt
        m.recovering = 0
        self.retry_after_s = max(1.0, dt * 2)
        self.last_recovery = {"kind": "cold", "duration_s": dt, **summary}
        self.recovering = False

    # -- observability -------------------------------------------------------
    def status(self) -> dict:
        m = self.metrics
        return {
            "recovering": self.recovering,
            "retry_after_s": self.retry_after_s,
            "recoveries_warm": m.counters["recoveries_warm"],
            "recoveries_cold": m.counters["recoveries_cold"],
            "quarantined_lanes": sorted(self.engine.quarantined),
            "capacity": self.engine.capacity,
            "last_recovery": self.last_recovery,
        }

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()
