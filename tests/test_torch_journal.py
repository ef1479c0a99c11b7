"""The port's write-ahead journal: framing, rotation, repair, replay.

``tests/test_journal.py`` and ``tests/test_journal_props.py`` re-pointed at
``repro_torch.serve.journal``: CRC framing round-trips arrays bit-exactly,
segments rotate and read back in lsn order, a torn tail is repaired on
reopen (and only the tail), the ``recover()`` fold is idempotent under any
crash point, and a recovered port engine re-serves outstanding work equal to
a serial ``run_int``.  Beside them, the cross-package contract: the same
append sequence writes byte-identical segment files in both packages, and
each package's ``read_records`` reads the other's journal.
"""

import pathlib

import numpy as np
import pytest
import torch

from repro.serve import journal as jjournal
from repro_torch.core.network import (
    NetworkConfig,
    float_params_from_numpy,
    quantize_params,
    run_int,
)
from repro_torch.core.snn_layer import LayerConfig, NeuronModel
from repro_torch.serve.journal import Journal, JournalCorruptError, read_records, recover
from repro_torch.serve.snn_engine import SNNServeEngine
from repro_torch.serve.streaming import StreamSessionManager

NET = NetworkConfig(
    layers=(
        LayerConfig(n_in=16, n_out=10, neuron=NeuronModel.LIF, beta=0.9),
        LayerConfig(n_in=10, n_out=4, neuron=NeuronModel.LIF, beta=0.77),
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
    return SNNServeEngine(NET, QPARAMS, device="cpu", **kw)


def _raster(T=8, seed=0, rate=0.4, n_in=NET.n_in):
    rng = np.random.default_rng(seed)
    return (rng.random((T, n_in)) < rate).astype(np.uint8)


# ---------------------------------------------------------------- framing
def test_append_read_roundtrip_preserves_fields_and_arrays(tmp_path):
    raster = _raster(seed=3)
    f32 = np.linspace(-1, 1, 7, dtype=np.float32).reshape(7, 1)
    with Journal(tmp_path) as j:
        assert j.append("submit", arrays={"raster": raster}, uid=5,
                        priority=2, tenant="t0", deadline_s=None) == 0
        assert j.append("done", uid=5, status="completed") == 1
        assert j.append("blob", arrays={"a": f32, "b": raster[:2]}) == 2
    recs = list(read_records(tmp_path))
    assert [r.lsn for r in recs] == [0, 1, 2]
    assert recs[0].kind == "submit"
    assert recs[0].fields == {"uid": 5, "priority": 2, "tenant": "t0", "deadline_s": None}
    np.testing.assert_array_equal(recs[0].arrays["raster"], raster)
    assert recs[0].arrays["raster"].dtype == np.uint8
    np.testing.assert_array_equal(recs[2].arrays["a"], f32)
    assert recs[2].arrays["a"].dtype == np.float32
    np.testing.assert_array_equal(recs[2].arrays["b"], raster[:2])


def test_reopen_resumes_lsn_and_appends_after_existing_records(tmp_path):
    with Journal(tmp_path) as j:
        for i in range(5):
            j.append("submit", uid=i)
    with Journal(tmp_path) as j:
        assert j.lsn == 5
        assert j.append("done", uid=0) == 5
    assert [r.kind for r in read_records(tmp_path)] == ["submit"] * 5 + ["done"]


def test_validation_rejects_bad_config(tmp_path):
    with pytest.raises(ValueError):
        Journal(tmp_path, segment_bytes=4)
    with pytest.raises(ValueError):
        Journal(tmp_path, fsync_every=0)


# --------------------------------------------------------------- rotation
def test_rotation_spreads_records_over_segments_in_lsn_order(tmp_path):
    raster = _raster()
    with Journal(tmp_path, segment_bytes=600) as j:
        for i in range(20):
            j.append("submit", arrays={"raster": raster}, uid=i)
    assert len(sorted(tmp_path.glob("segment_*.wal"))) > 1
    recs = list(read_records(tmp_path))
    assert [r.fields["uid"] for r in recs] == list(range(20))
    assert [r.lsn for r in recs] == list(range(20))


def test_explicit_rotate_seals_segment_and_reopen_counts_across(tmp_path):
    with Journal(tmp_path) as j:
        j.append("submit", uid=0)
        j.rotate()
        j.append("submit", uid=1)
    with Journal(tmp_path) as j:
        assert j.lsn == 2


# ----------------------------------------------------------------- repair
def _torn_copy(tmp_path, n_records, cut):
    """A journal with ``n_records`` whole frames, then ``cut`` bytes
    chopped off the tail segment."""
    with Journal(tmp_path) as j:
        for i in range(n_records):
            j.append("submit", arrays={"raster": _raster(seed=i)}, uid=i)
    seg = sorted(tmp_path.glob("segment_*.wal"))[-1]
    data = seg.read_bytes()
    seg.write_bytes(data[: len(data) - cut])
    return seg


@pytest.mark.parametrize("cut", [1, 50, 150])
def test_torn_tail_is_dropped_on_read_and_repaired_on_reopen(tmp_path, cut):
    _torn_copy(tmp_path, 6, cut)
    assert [r.fields["uid"] for r in read_records(tmp_path)] == list(range(5))
    with Journal(tmp_path) as j:  # reopen: truncates, then appends cleanly
        assert j.lsn == 5
        j.append("submit", uid=99)
    assert [r.fields["uid"] for r in read_records(tmp_path)] == [0, 1, 2, 3, 4, 99]


def test_interior_segment_damage_refuses_instead_of_recovering_half(tmp_path):
    with Journal(tmp_path, segment_bytes=600) as j:
        for i in range(20):
            j.append("submit", arrays={"raster": _raster()}, uid=i)
    first = sorted(tmp_path.glob("segment_*.wal"))[0]
    data = bytearray(first.read_bytes())
    data[len(data) // 2] ^= 0xFF  # bit rot in a sealed, non-tail segment
    first.write_bytes(bytes(data))
    with pytest.raises(JournalCorruptError):
        list(read_records(tmp_path))
    with pytest.raises(JournalCorruptError):
        Journal(tmp_path)


def test_crash_during_segment_creation_is_an_empty_tail(tmp_path):
    with Journal(tmp_path) as j:
        j.append("submit", uid=0)
    (pathlib.Path(tmp_path) / "segment_00000001.wal").write_bytes(b"NRA")
    assert [r.fields["uid"] for r in read_records(tmp_path)] == [0]


# ------------------------------------------------------------ recover fold
def test_recover_folds_submit_done_into_outstanding_set(tmp_path):
    with Journal(tmp_path) as j:
        for i in range(6):
            j.append("submit", arrays={"raster": _raster(seed=i)}, uid=i,
                     priority=1, tenant="default", deadline_s=None)
        j.append("done", uid=1, status="completed")
        j.append("done", uid=4, status="completed")
    state = recover(tmp_path)
    assert sorted(r["uid"] for r in state.requests) == [0, 2, 3, 5]
    assert state.n_done == 2 and state.n_records == 8
    for r in state.requests:
        np.testing.assert_array_equal(r["raster"], _raster(seed=r["uid"]))


def test_recover_session_fold_tracks_feeds_watermark_and_close(tmp_path):
    c0, c1, c2 = _raster(3, seed=1), _raster(4, seed=2), _raster(2, seed=3)
    with Journal(tmp_path) as j:
        j.append("session_open", sid="a", config={"window": 4, "stride": 2})
        j.append("feed", arrays={"chunk": c0}, sid="a", start=0)
        j.append("feed", arrays={"chunk": c1}, sid="a", start=3)
        j.append("evict", sid="a", t_total=7)
        j.append("feed", arrays={"chunk": c2}, sid="a", start=7)
        j.append("session_open", sid="b", config={})
        j.append("session_close", sid="b")
    state = recover(tmp_path)
    assert set(state.sessions) == {"a"}
    s = state.sessions["a"]
    assert s.config == {"window": 4, "stride": 2}
    assert s.ckpt_t == 7 and s.fed_steps == 9
    assert [(st, ch.shape[0]) for st, ch in s.feeds] == [(7, 2)]


def test_recover_reopen_of_live_session_merges_instead_of_resetting(tmp_path):
    c0 = _raster(5, seed=1)
    with Journal(tmp_path) as j:
        j.append("session_open", sid="a", config={"window": 4})
        j.append("feed", arrays={"chunk": c0}, sid="a", start=0)
        j.append("session_open", sid="a", config={"window": 4})
        j.append("feed", arrays={"chunk": c0}, sid="a", start=0)
    s = recover(tmp_path).sessions["a"]
    assert s.fed_steps == 5
    assert all(st == 0 and ch.shape[0] == 5 for st, ch in s.feeds)


def test_apply_refuses_sessions_without_a_manager(tmp_path):
    with Journal(tmp_path) as j:
        j.append("session_open", sid="a", config={})
    with pytest.raises(ValueError, match="live sessions"):
        recover(tmp_path).apply(_engine(max_batch=2))


def test_apply_detects_feed_gap_as_corruption(tmp_path):
    with Journal(tmp_path) as j:
        j.append("session_open", sid="a", config={})
        j.append("feed", arrays={"chunk": _raster(3, seed=1)}, sid="a", start=0)
        # steps [3, 5) never journaled: the stream cannot be reconstructed
        j.append("feed", arrays={"chunk": _raster(2, seed=2)}, sid="a", start=5)
    engine = _engine(max_batch=2)
    with pytest.raises(JournalCorruptError, match="gap"):
        recover(tmp_path).apply(engine, StreamSessionManager(engine))


# ---------------------------------------------------------- apply end-to-end
def test_apply_resubmits_outstanding_and_reserves_bit_exactly(tmp_path):
    rasters = {i: _raster(seed=10 + i) for i in range(4)}
    with Journal(tmp_path) as j:
        for i, r in rasters.items():
            j.append("submit", arrays={"raster": r}, uid=i, priority=1,
                     tenant="default", deadline_s=None)
        j.append("done", uid=2, status="completed")
    engine = _engine(max_batch=2)
    summary = recover(tmp_path).apply(engine)
    assert summary["requests_resubmitted"] == 3
    done = {r.uid: r for r in engine.drain()}
    assert sorted(done) == [0, 1, 3]
    for uid, req in done.items():
        x = torch.from_numpy(rasters[uid][:, None, :].astype(np.int32))
        np.testing.assert_array_equal(req.spike_counts, run_int(NET, QPARAMS, x).spike_counts[0])


# ------------------------------------------------------------ cross-package
def _append_sequence(journal_cls, root):
    """Every record kind the serving stack writes, across a rotation."""
    with journal_cls(root, segment_bytes=700, fsync_every=3) as j:
        for i in range(4):
            j.append("submit", arrays={"raster": _raster(seed=i)}, uid=i, priority=i % 3,
                     tenant=f"t{i}", deadline_s=None if i % 2 else 0.25)
        j.append("done", uid=1, status="completed")
        j.append("session_open", sid="s", config={"window": 8, "priority": 3})
        j.append("feed", arrays={"chunk": _raster(5, seed=9).astype(np.int64)}, sid="s", start=0)
        j.append("evict", sid="s", t_total=5)
        j.append("feed", arrays={"chunk": _raster(3, seed=8)}, sid="s", start=5)
        j.append("blob", arrays={"f": np.linspace(-1, 1, 6, dtype=np.float32)})
        j.append("session_close", sid="s")


def test_same_appends_write_byte_identical_segments(tmp_path):
    _append_sequence(Journal, tmp_path / "torch")
    _append_sequence(jjournal.Journal, tmp_path / "jax")
    got = sorted((tmp_path / "torch").glob("segment_*.wal"))
    want = sorted((tmp_path / "jax").glob("segment_*.wal"))
    assert [p.name for p in got] == [p.name for p in want] and len(got) > 1
    for a, b in zip(got, want):
        assert a.read_bytes() == b.read_bytes()


def _records(read, root):
    return [(r.lsn, r.kind, r.fields, {k: (v.dtype, v.tobytes()) for k, v in r.arrays.items()})
            for r in read(root)]


def test_each_package_reads_the_others_journal(tmp_path):
    _append_sequence(Journal, tmp_path / "torch")
    _append_sequence(jjournal.Journal, tmp_path / "jax")
    for root in (tmp_path / "torch", tmp_path / "jax"):
        assert _records(read_records, root) == _records(jjournal.read_records, root)
        assert len(_records(read_records, root)) == 11
    mine, theirs = recover(tmp_path / "jax"), jjournal.recover(tmp_path / "torch")
    assert [r["uid"] for r in mine.requests] == [r["uid"] for r in theirs.requests] == [0, 2, 3]
    for a, b in zip(mine.requests, theirs.requests):
        np.testing.assert_array_equal(a["raster"], b["raster"])
        assert (a["priority"], a["tenant"], a["deadline_s"]) == (
            b["priority"], b["tenant"], b["deadline_s"])
    assert mine.sessions == {} and theirs.sessions == {}


# ------------------------------------------------- replay-idempotency props
try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # hypothesis is a CI-only dependency (requirements-dev)
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    _SETTINGS = dict(deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])

    def _r8(T, seed):
        return _raster(T, seed, n_in=8)

    @st.composite
    def _request_histories(draw):
        """ops: ("submit", uid) admits (or re-admits) uid; ("done", uid)
        completes it; completions only follow their submit."""
        n = draw(st.integers(1, 12))
        order = draw(st.permutations(list(range(n))))
        done = draw(st.sets(st.sampled_from(list(range(n))), max_size=n))
        seq, submitted = [], []
        for uid in order:
            seq.append(("submit", uid))
            submitted.append(uid)
            for d in list(done):
                if d in submitted and draw(st.booleans()):
                    seq.append(("done", d))
                    done.discard(d)
        for d in sorted(done):
            if d in submitted:
                seq.append(("done", d))
        return seq

    def _journal_history(tmp, history):
        with Journal(tmp, fsync_every=1) as j:
            for kind, uid in history:
                if kind == "submit":
                    j.append("submit", arrays={"raster": _r8(4, uid)}, uid=uid)
                else:
                    j.append("done", uid=uid, status="completed")

    @given(history=_request_histories(), crash_frac=st.floats(0.0, 1.0))
    @settings(max_examples=30, **_SETTINGS)
    def test_prefix_replay_matches_model_and_never_duplicates(
        tmp_path_factory, history, crash_frac
    ):
        tmp = tmp_path_factory.mktemp("wal")
        prefix = history[: int(round(crash_frac * len(history)))]
        _journal_history(tmp, prefix)
        state = recover(tmp)
        model = set()
        for kind, uid in prefix:
            (model.add if kind == "submit" else model.discard)(uid)
        uids = [r["uid"] for r in state.requests]
        assert sorted(uids) == sorted(model)
        assert len(uids) == len(set(uids))  # a fold cannot double-admit
        for r in state.requests:
            np.testing.assert_array_equal(r["raster"], _r8(4, r["uid"]))

    @given(history=_request_histories(), crash_frac=st.floats(0.0, 1.0))
    @settings(max_examples=30, **_SETTINGS)
    def test_recovery_rejournal_then_second_crash_converges(
        tmp_path_factory, history, crash_frac
    ):
        """Crash, recover, re-journal the recovery, crash again, recover
        again: the second recovery equals the first."""
        tmp = tmp_path_factory.mktemp("wal")
        _journal_history(tmp, history[: int(round(crash_frac * len(history)))])
        first = recover(tmp)
        with Journal(tmp, fsync_every=1) as j:  # recovery re-admits everything
            for r in first.requests:
                j.append("submit", arrays={"raster": r["raster"]}, uid=r["uid"])
        second = recover(tmp)
        assert sorted(r["uid"] for r in second.requests) == sorted(
            r["uid"] for r in first.requests
        )

    @given(n_records=st.integers(1, 15), cut_bytes=st.integers(1, 400))
    @settings(max_examples=30, **_SETTINGS)
    def test_byte_level_torn_tail_always_yields_a_clean_prefix(
        tmp_path_factory, n_records, cut_bytes
    ):
        tmp = tmp_path_factory.mktemp("wal")
        with Journal(tmp, fsync_every=1) as j:
            for i in range(n_records):
                j.append("submit", arrays={"raster": _r8(4, i)}, uid=i)
        seg = sorted(tmp.glob("segment_*.wal"))[-1]
        data = seg.read_bytes()
        seg.write_bytes(data[: max(0, len(data) - cut_bytes)])
        uids = [r.fields["uid"] for r in read_records(tmp)]
        assert uids == list(range(len(uids)))  # a prefix, never a gap or garbage
        with Journal(tmp, fsync_every=1) as j:  # and the repair resumes cleanly
            j.append("submit", uid=999)
        assert [r.fields["uid"] for r in read_records(tmp)][-1] == 999

    @st.composite
    def _chunk_schedules(draw):
        total = draw(st.integers(1, 40))
        edges = sorted(draw(st.sets(st.integers(1, max(1, total - 1)), max_size=6)) | {0, total})
        evict_after = draw(st.sets(st.integers(0, max(0, len(edges) - 2)), max_size=2))
        return total, edges, evict_after

    @given(sched=_chunk_schedules(), refeed=st.booleans())
    @settings(max_examples=40, **_SETTINGS)
    def test_session_suffix_assembly_covers_exactly_the_unfed_steps(
        tmp_path_factory, sched, refeed
    ):
        """The fold's pruned feed list reconstructs raster[ckpt_t:fed]
        gaplessly, also when a prior recovery re-fed overlapping records."""
        total, edges, evict_after = sched
        stream = _r8(total, seed=7)
        tmp = tmp_path_factory.mktemp("wal")
        with Journal(tmp, fsync_every=1) as j:
            j.append("session_open", sid="s", config={"window": 4, "stride": 2})
            for i in range(len(edges) - 1):
                j.append("feed", arrays={"chunk": stream[edges[i]:edges[i + 1]]},
                         sid="s", start=edges[i])
                if i in evict_after:
                    j.append("evict", sid="s", t_total=edges[i + 1])
            if refeed and len(edges) > 2:
                j.append("feed", arrays={"chunk": stream[edges[-3]:]}, sid="s", start=edges[-3])
        s = recover(tmp).sessions["s"]
        f0 = s.ckpt_t or 0
        assert s.fed_steps == total
        if f0 < total:
            buf = np.zeros((total - f0, stream.shape[1]), stream.dtype)
            covered = np.zeros(total - f0, bool)
            for start, chunk in s.feeds:
                lo = max(start, f0)
                buf[lo - f0 : start + chunk.shape[0] - f0] = chunk[lo - start :]
                covered[lo - f0 : start + chunk.shape[0] - f0] = True
            assert covered.all()
            np.testing.assert_array_equal(buf, stream[f0:])

else:  # pragma: no cover - visible skip in environments without hypothesis

    @pytest.mark.skip(reason="hypothesis not installed (CI-only dependency)")
    def test_journal_replay_properties():
        pass
