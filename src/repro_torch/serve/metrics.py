"""Rolling-window serving metrics: the engine's StatLogger.

Pure host-side observability for :class:`~repro_torch.serve.snn_engine.
SNNServeEngine` -- no jax, no device traffic, O(1) amortised per event:

* **counters** -- monotonic totals (submitted / completed / degraded /
  rejected / preempted / resumed / callback_failures / per-route hits);
* **rolling windows** -- the last ``window_s`` seconds of per-request
  latency (overall and per priority class), queue depth, and lane
  occupancy, reported as p50/p99/mean over the window (a deployment's
  "current" percentiles, not lifetime averages);
* **rates** -- an EWMA of wall seconds per simulated lane step
  (``est_step_s``), which is the service-time estimate the scheduler's
  deadline verdicts consume, plus cumulative dispatch vs. tick wall time
  so the offered-load sweep can show where scheduling (host bookkeeping)
  rather than compute (the jitted tick) becomes the bottleneck.

``snapshot()`` returns one nested dict (what ``/healthz`` dashboards and
the benchmark record); ``prometheus_text()`` renders the same state in
Prometheus exposition format for the HTTP front-end's ``/metrics``.
"""

from __future__ import annotations

import time
from collections import Counter, deque

from repro_torch.serve.scheduler import Priority

__all__ = ["RollingWindow", "ServeMetrics"]


def _percentile(values: list[float], p: float) -> float:
    """Nearest-rank percentile over a small sample (no numpy dependency in
    the hot path; windows are capped at a few thousand samples)."""
    if not values:
        return 0.0
    s = sorted(values)
    k = max(0, min(len(s) - 1, int(round((p / 100.0) * (len(s) - 1)))))
    return s[k]


class RollingWindow:
    """Time-bounded sample window: keeps (timestamp, value) pairs no older
    than ``window_s`` (and at most ``max_samples``, evicting oldest)."""

    def __init__(self, window_s: float = 60.0, max_samples: int = 4096):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = window_s
        self._samples: deque[tuple[float, float]] = deque(maxlen=max_samples)
        self.total_count = 0  # lifetime, survives eviction

    def add(self, value: float, now: float | None = None) -> None:
        now = time.perf_counter() if now is None else now
        self._samples.append((now, float(value)))
        self.total_count += 1

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def values(self, now: float | None = None) -> list[float]:
        self._prune(time.perf_counter() if now is None else now)
        return [v for _, v in self._samples]

    def count(self, now: float | None = None) -> int:
        return len(self.values(now))

    def mean(self, now: float | None = None) -> float:
        vals = self.values(now)
        return sum(vals) / len(vals) if vals else 0.0

    def percentile(self, p: float, now: float | None = None) -> float:
        return _percentile(self.values(now), p)


class ServeMetrics:
    """The serving engine's rolling StatLogger (see module docstring)."""

    #: EWMA smoothing for the per-step service-time estimate.
    STEP_EWMA = 0.3

    def __init__(self, window_s: float = 60.0, max_samples: int = 4096):
        self.window_s = window_s
        self.counters: Counter = Counter()
        self.latency = {cls: RollingWindow(window_s, max_samples) for cls in Priority}
        self.latency_all = RollingWindow(window_s, max_samples)
        self.queue_depth = RollingWindow(window_s, max_samples)
        self.lane_occupancy = RollingWindow(window_s, max_samples)  # fraction 0..1
        # -- streaming sessions (not ported yet: gauges stay 0) ---------------
        # gauges are set by the session manager; counters ride self.counters
        # (sessions_opened / sessions_closed / sessions_evicted /
        # sessions_restored / session_chunks / session_readouts)
        self.live_sessions = 0  # gauge: open sessions currently resident
        self.evicted_sessions = 0  # gauge: open sessions parked on disk
        self.readout_latency = RollingWindow(window_s, max_samples)  # feed->readout s
        # -- NeurA-Guard recovery (not ported yet: gauges stay 0) -------------
        # gauges set by the supervisor; counters ride self.counters
        # (recoveries_warm / recoveries_cold / tick_retries / slow_ticks /
        # quarantined_lanes / quarantine_restarts / requests_resubmitted /
        # journal_records_replayed)
        self.recovering = 0  # gauge: 1 while a restart/replay is in progress
        self.recovery_s = 0.0  # cumulative wall seconds spent recovering
        self._est_step_s: float | None = None
        self.dispatch_s = 0.0  # cumulative host scheduling/bookkeeping wall
        self.tick_s = 0.0  # cumulative jitted-advance wall (incl. readback)
        self.direct_s = 0.0  # cumulative direct event-route serve wall
        self.degrade_s = 0.0  # cumulative degraded express-batch serve wall
        self.n_ticks = 0
        self.n_steps = 0

    # -- recording -----------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def record_finish(self, req, now: float) -> None:
        """One request reached a terminal served state (completed/degraded)."""
        self.inc(req.status)
        if req.route is not None:
            self.inc(f"route:{req.route}")
        if req.latency_s is not None:
            self.latency_all.add(req.latency_s, now)
            self.latency[Priority(req.priority)].add(req.latency_s, now)

    def record_reject(self, req, now: float) -> None:
        self.inc("rejected")

    def record_tick(
        self, k_steps: int, wall_s: float, queue_depth: int, active: int, n_lanes: int,
        now: float,
    ) -> None:
        self.n_ticks += 1
        self.n_steps += k_steps
        self.tick_s += wall_s
        self.queue_depth.add(queue_depth, now)
        self.lane_occupancy.add(active / max(1, n_lanes), now)
        if k_steps > 0 and wall_s > 0:
            step = wall_s / k_steps
            if self._est_step_s is None:
                self._est_step_s = step
            else:
                self._est_step_s += self.STEP_EWMA * (step - self._est_step_s)

    def seed_step_estimate(self, step_s: float) -> None:
        """Pin the service-time estimate (deterministic tests; cold starts)."""
        self._est_step_s = float(step_s)

    # -- reading -------------------------------------------------------------
    @property
    def est_step_s(self) -> float | None:
        """EWMA wall seconds per simulated lane step (None until a tick)."""
        return self._est_step_s

    def event_route_hit_rate(self) -> float:
        """Fraction of served (completed + degraded) requests that took any
        ``event-*`` route."""
        served = self.counters["completed"] + self.counters["degraded"]
        if not served:
            return 0.0
        hits = sum(
            n for key, n in self.counters.items()
            if key.startswith("route:event-")
        )
        return hits / served

    def snapshot(self, now: float | None = None) -> dict:
        now = time.perf_counter() if now is None else now
        lat = {
            "all": {
                "p50_ms": self.latency_all.percentile(50, now) * 1e3,
                "p99_ms": self.latency_all.percentile(99, now) * 1e3,
                "mean_ms": self.latency_all.mean(now) * 1e3,
                "window_count": self.latency_all.count(now),
            }
        }
        for cls in Priority:
            w = self.latency[cls]
            if w.total_count:
                lat[cls.name.lower()] = {
                    "p50_ms": w.percentile(50, now) * 1e3,
                    "p99_ms": w.percentile(99, now) * 1e3,
                    "mean_ms": w.mean(now) * 1e3,
                    "window_count": w.count(now),
                }
        return {
            "counters": dict(self.counters),
            "latency": lat,
            "queue_depth": {
                "current": self.queue_depth.values(now)[-1:] or [0.0],
                "mean": self.queue_depth.mean(now),
                "p99": self.queue_depth.percentile(99, now),
            },
            "lane_occupancy": {
                "mean": self.lane_occupancy.mean(now),
                "p99": self.lane_occupancy.percentile(99, now),
            },
            "event_route_hit_rate": self.event_route_hit_rate(),
            "streaming": {
                "live_sessions": self.live_sessions,
                "evicted_sessions": self.evicted_sessions,
                "evictions": self.counters["sessions_evicted"],
                "resumes": self.counters["sessions_restored"],
                "readout_latency_ms": {
                    "p50": self.readout_latency.percentile(50, now) * 1e3,
                    "p99": self.readout_latency.percentile(99, now) * 1e3,
                    "window_count": self.readout_latency.count(now),
                },
            },
            "recovery": {
                "recovering": bool(self.recovering),
                "warm": self.counters["recoveries_warm"],
                "cold": self.counters["recoveries_cold"],
                "tick_retries": self.counters["tick_retries"],
                "slow_ticks": self.counters["slow_ticks"],
                "quarantined_lanes": self.counters["quarantined_lanes"],
                "quarantine_restarts": self.counters["quarantine_restarts"],
                "recovery_s": self.recovery_s,
            },
            "est_step_s": self._est_step_s,
            "ticks": self.n_ticks,
            "steps": self.n_steps,
            "dispatch_s": self.dispatch_s,
            "tick_s": self.tick_s,
            "direct_s": self.direct_s,
            "degrade_s": self.degrade_s,
        }

    def prometheus_text(self, now: float | None = None) -> str:
        """Prometheus exposition-format rendering of :meth:`snapshot`.

        Every family carries its ``# HELP`` and ``# TYPE`` header exactly
        once, immediately before its samples -- the strict layout the
        text-format parsers require (and that
        ``tests/test_metrics_exposition.py`` enforces, so new families
        cannot silently drift out of format as they accumulate).
        """
        now = time.perf_counter() if now is None else now
        lines: list[str] = []

        def family(name: str, ftype: str, help_text: str) -> None:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {ftype}")

        family("neura_requests_total", "counter", "Requests by terminal outcome.")
        for outcome in ("submitted", "completed", "degraded", "rejected"):
            lines.append(
                f'neura_requests_total{{outcome="{outcome}"}} {self.counters[outcome]}'
            )
        family(
            "neura_scheduler_events_total",
            "counter",
            "Control-plane events (preemption, resume, callback/HTTP failures).",
        )
        for event in ("preempted", "resumed", "callback_failures", "http_disconnects"):
            lines.append(
                f'neura_scheduler_events_total{{event="{event}"}} {self.counters[event]}'
            )
        family(
            "neura_route_requests_total", "counter", "Served requests by serving route."
        )
        for key, n in sorted(self.counters.items()):
            if key.startswith("route:"):
                lines.append(
                    f'neura_route_requests_total{{route="{key[6:]}"}} {n}'
                )
        family(
            "neura_request_latency_seconds",
            "summary",
            "Arrival-to-terminal latency quantiles over the rolling window.",
        )
        for label, window in [("all", self.latency_all)] + [
            (cls.name.lower(), self.latency[cls]) for cls in Priority
        ]:
            for q in (0.5, 0.99):
                lines.append(
                    f'neura_request_latency_seconds{{class="{label}",quantile="{q}"}} '
                    f"{window.percentile(q * 100, now):.6g}"
                )
        family("neura_queue_depth", "gauge", "Scheduler queue depth at the last tick.")
        cur = self.queue_depth.values(now)
        lines.append(f"neura_queue_depth {cur[-1] if cur else 0:g}")
        family(
            "neura_lane_occupancy", "gauge", "Active fraction of the lane pool (0..1)."
        )
        occ = self.lane_occupancy.values(now)
        lines.append(f"neura_lane_occupancy {occ[-1] if occ else 0:.6g}")
        family(
            "neura_event_route_hit_rate",
            "gauge",
            "Fraction of served requests that took an event-* route.",
        )
        lines.append(f"neura_event_route_hit_rate {self.event_route_hit_rate():.6g}")
        family("neura_stream_sessions", "gauge", "Open streaming sessions by residence.")
        lines.append(f'neura_stream_sessions{{state="live"}} {self.live_sessions}')
        lines.append(f'neura_stream_sessions{{state="evicted"}} {self.evicted_sessions}')
        family(
            "neura_stream_events_total", "counter", "Streaming-session lifecycle events."
        )
        for event in (
            "sessions_opened",
            "sessions_closed",
            "sessions_evicted",
            "sessions_restored",
            "session_chunks",
            "session_readouts",
        ):
            lines.append(
                f'neura_stream_events_total{{event="{event}"}} {self.counters[event]}'
            )
        family(
            "neura_stream_readout_latency_seconds",
            "summary",
            "Feed-arrival-to-readout latency quantiles over the rolling window.",
        )
        for q in (0.5, 0.99):
            lines.append(
                f'neura_stream_readout_latency_seconds{{quantile="{q}"}} '
                f"{self.readout_latency.percentile(q * 100, now):.6g}"
            )
        # -- NeurA-Guard recovery / quarantine (not ported yet) ---------------
        family(
            "neura_recovering",
            "gauge",
            "1 while the supervisor is restarting or replaying the journal.",
        )
        lines.append(f"neura_recovering {self.recovering}")
        family(
            "neura_recovery_total",
            "counter",
            "Engine restarts by kind (warm = host salvage, cold = journal replay).",
        )
        for kind in ("warm", "cold"):
            lines.append(
                f'neura_recovery_total{{kind="{kind}"}} '
                f"{self.counters[f'recoveries_{kind}']}"
            )
        family(
            "neura_recovery_seconds_total",
            "counter",
            "Cumulative wall seconds spent in restarts and journal replay.",
        )
        lines.append(f"neura_recovery_seconds_total {self.recovery_s:.6g}")
        family(
            "neura_recovery_events_total",
            "counter",
            "Recovery-path events (retries, slow ticks, replayed WAL records).",
        )
        for event in (
            "tick_retries",
            "slow_ticks",
            "requests_resubmitted",
            "journal_records_replayed",
        ):
            lines.append(
                f'neura_recovery_events_total{{event="{event}"}} {self.counters[event]}'
            )
        family(
            "neura_quarantine_lanes_total",
            "counter",
            "Lane slots condemned by the carry validity sweep.",
        )
        lines.append(f"neura_quarantine_lanes_total {self.counters['quarantined_lanes']}")
        family(
            "neura_quarantine_restarts_total",
            "counter",
            "Requests restarted from a seam after their lane was quarantined.",
        )
        lines.append(
            f"neura_quarantine_restarts_total {self.counters['quarantine_restarts']}"
        )
        family("neura_ticks_total", "counter", "Jitted chunk advances dispatched.")
        lines.append(f"neura_ticks_total {self.n_ticks}")
        family("neura_steps_total", "counter", "Simulated time steps advanced.")
        lines.append(f"neura_steps_total {self.n_steps}")
        family(
            "neura_dispatch_seconds_total",
            "counter",
            "Cumulative host scheduling/bookkeeping wall seconds.",
        )
        lines.append(f"neura_dispatch_seconds_total {self.dispatch_s:.6g}")
        family(
            "neura_tick_seconds_total",
            "counter",
            "Cumulative jitted-advance wall seconds (readback included).",
        )
        lines.append(f"neura_tick_seconds_total {self.tick_s:.6g}")
        return "\n".join(lines) + "\n"
