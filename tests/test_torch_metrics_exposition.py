"""Strict Prometheus text-exposition checks for the port's ``ServeMetrics``.

``test_metrics_exposition.py``'s grammar parse, pointed at
``repro_torch.serve.metrics``: every sample family carries exactly one
``# HELP`` and one ``# TYPE`` line before its first sample, sample lines
match the exposition grammar, and no (name, labels) pair repeats.  Beside
it, the same counter and observation calls on JAX's ``ServeMetrics`` and the
port's give the same families, the same ``# HELP`` / ``# TYPE`` lines and
the same label sets.
"""

import re

import pytest

from repro.serve import metrics as jmetrics
from repro.serve import scheduler as jsched
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import Priority

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE = re.compile(
    rf"^({_NAME})(?:\{{((?:{_NAME}=\"[^\"\\\n]*\",?)*)\}})? (-?[0-9.e+-]+|NaN|[+-]Inf)$"
)
_HELP = re.compile(rf"^# HELP ({_NAME}) \S.*$")
_TYPE = re.compile(rf"^# TYPE ({_NAME}) (counter|gauge|histogram|summary|untyped)$")


def _populated_metrics(cls=ServeMetrics, priority=Priority.STANDARD):
    """A metrics object with activity in every family."""
    m = cls()

    class _Req:
        uid = 0
        tenant = "default"
        latency_s = 0.012
        status = "completed"
        route = "lanes"
        tier = "full"

    _Req.priority = priority
    m.inc("submitted")
    m.inc("completed")
    m.inc("rejected")
    m.record_finish(_Req(), now=0.0)
    for k in ("sessions_opened", "sessions_closed", "sessions_evicted",
              "sessions_restored", "session_chunks", "session_readouts"):
        m.inc(k)
    for k in ("recoveries_warm", "recoveries_cold", "tick_retries",
              "slow_ticks", "quarantined_lanes", "quarantine_restarts",
              "requests_resubmitted", "journal_records_replayed"):
        m.inc(k)
    m.recovering = 1
    m.recovery_s = 0.25
    return m


def _parse(text):
    """Parse exposition text; returns (helps, types, samples) or asserts."""
    helps, types, samples = {}, {}, []
    seen_sample_of = set()
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            match = _HELP.match(line)
            assert match, f"line {i}: malformed HELP: {line!r}"
            name = match.group(1)
            assert name not in helps, f"duplicate HELP for {name}"
            assert name not in seen_sample_of, f"HELP for {name} after samples"
            helps[name] = line
        elif line.startswith("# TYPE "):
            match = _TYPE.match(line)
            assert match, f"line {i}: malformed TYPE: {line!r}"
            name = match.group(1)
            assert name not in types, f"duplicate TYPE for {name}"
            assert name not in seen_sample_of, f"TYPE for {name} after samples"
            types[name] = match.group(2)
        elif line.startswith("#"):
            pytest.fail(f"line {i}: unknown comment directive: {line!r}")
        else:
            match = _SAMPLE.match(line)
            assert match, f"line {i}: malformed sample: {line!r}"
            name, labels, value = match.groups()
            float(value)
            samples.append((name, labels or "", value))
            seen_sample_of.add(name)
    return helps, types, samples


def test_every_family_has_help_and_type_before_samples():
    helps, types, samples = _parse(_populated_metrics().prometheus_text())
    for name, _, _ in samples:
        assert name in types, f"family {name} has samples but no # TYPE"
        assert name in helps, f"family {name} has samples but no # HELP"


def test_no_duplicate_name_label_pairs():
    _, _, samples = _parse(_populated_metrics().prometheus_text())
    keys = [(n, l) for n, l, _ in samples]
    assert len(keys) == len(set(keys)), "duplicate (name, labels) sample"


def test_recovery_and_quarantine_families_are_present_and_typed():
    helps, types, samples = _parse(_populated_metrics().prometheus_text())
    by_name = {}
    for name, labels, value in samples:
        by_name.setdefault(name, []).append((labels, value))
    assert types["neura_recovering"] == "gauge"
    assert by_name["neura_recovering"] == [("", "1")]
    assert types["neura_recovery_total"] == "counter"
    assert dict(by_name["neura_recovery_total"]) == {'kind="warm"': "1", 'kind="cold"': "1"}
    assert types["neura_recovery_seconds_total"] == "counter"
    assert float(by_name["neura_recovery_seconds_total"][0][1]) == 0.25
    events = dict(by_name["neura_recovery_events_total"])
    for ev in ("tick_retries", "slow_ticks", "requests_resubmitted", "journal_records_replayed"):
        assert events[f'event="{ev}"'] == "1"
    assert types["neura_quarantine_lanes_total"] == "counter"
    assert types["neura_quarantine_restarts_total"] == "counter"


def test_preexisting_families_kept_their_names_and_gained_metadata():
    helps, types, samples = _parse(_populated_metrics().prometheus_text())
    names = {n for n, _, _ in samples}
    for family in (
        "neura_requests_total",
        "neura_scheduler_events_total",
        "neura_route_requests_total",
        "neura_request_latency_seconds",
        "neura_stream_sessions",
        "neura_stream_events_total",
        "neura_ticks_total",
    ):
        assert family in types and family in helps
        assert family in names, f"{family} lost its samples"


def _ticked(m):
    m.record_tick(4, 0.01, queue_depth=2, active=1, n_lanes=2, now=0.0)
    m.record_tick(8, 0.03, queue_depth=0, active=2, n_lanes=2, now=0.5)
    return m


@pytest.mark.parametrize("ticked", [False, True], ids=["requests", "requests+ticks"])
def test_families_help_type_and_labels_equal_jax(ticked):
    """The same calls on both packages' ``ServeMetrics``: the same family
    names in the same order, the same HELP / TYPE lines, and each family's
    samples with the same label sets."""
    port = _populated_metrics()
    jax_m = _populated_metrics(jmetrics.ServeMetrics, jsched.Priority.STANDARD)
    if ticked:
        port, jax_m = _ticked(port), _ticked(jax_m)
    ph, pt, ps = _parse(port.prometheus_text(now=1.0))
    jh, jt, js = _parse(jax_m.prometheus_text(now=1.0))
    assert list(ph) == list(jh)
    assert ph == jh and pt == jt
    assert [(n, l) for n, l, _ in ps] == [(n, l) for n, l, _ in js]
    # counters and gauges that depend on no clock agree in value as well
    clockless = {"neura_requests_total", "neura_recovery_total", "neura_recovering",
                 "neura_recovery_events_total", "neura_stream_events_total"}
    assert [s for s in ps if s[0] in clockless] == [s for s in js if s[0] in clockless]
