"""NeurA-Guard write-ahead journal: serve-state durability + replay.

Port of ``repro/serve/journal.py`` (numpy only).  The segment format is
byte for byte the JAX package's, so either package reads the other's
journal; ``RecoveredState.apply`` rebuilds the port's requests and
sessions.

The engine and the stream-session manager are pure in-memory machines: a
crash loses every queued request and every live session carry.  This
module gives them a durability spine -- an append-only, CRC-framed,
fsync-batched write-ahead log whose replay reconstructs the scheduler
queue and the session registry **such that resumed results are bit-exact
with an uninterrupted run**:

* a queued/in-flight request restarts from admission (its raster is in
  the journal; serving is a pure function of the raster, so the re-run
  is bit-identical);
* a live stream session restores from its latest checkpoint (the
  evict-time carry seam, CRC-verified by ``repro_torch.checkpoint``) and
  re-feeds the journaled feed suffix beyond the checkpoint watermark --
  the carry chain continues exactly where the uninterrupted run's would.

Record kinds (who writes them):

=================  ======================  =================================
kind               writer                  recovery meaning
=================  ======================  =================================
``submit``         engine ``submit()``     request entered the scheduler
``done``           engine finalize         request reached a terminal state
``session_open``   manager ``open()``      stream exists (config captured)
``feed``           manager ``feed()``      raster steps accepted (with the
                                           session's pre-feed step offset)
``evict``          manager ``evict()``     a checkpoint exists at ``t_total``
``session_close``  manager ``close()``     stream finished; nothing to do
=================  ======================  =================================

On-disk format -- ``<root>/segment_%08d.wal``, each an 8-byte magic
followed by frames::

    frame   := header payload
    header  := u32 payload_len, u32 crc32(payload)     (little-endian)
    payload := u32 meta_len, meta_json, raw array bytes (concatenated)

``meta_json`` is ``{"kind", "fields", "arrays": [[name, dtype, shape],
...]}``; arrays travel as raw C-order bytes after it, so a raster round-
trips without base64 inflation.  Appends batch fsyncs (``fsync_every``)
and rotate segments atomically (new segment file + magic is fsynced, and
the directory entry with it, before any frame lands in it).  Reopening a
journal repairs a torn tail: the last segment is truncated at the end of
its last whole, CRC-valid frame -- a crash mid-append costs at most the
unsynced suffix, never the journal.

Replay idempotency falls out of keying: recovery folds records into
dicts keyed by request uid / session sid, so replaying any prefix,
crashing, and replaying again converges on the same recovered state --
the property suite (``tests/test_journal_props.py``) hammers exactly
this.  Fsync batching means the tail of the journal is *at-least-once*:
a ``done`` record still in the OS buffer at kill time is lost and the
request is re-served on recovery -- standard WAL semantics; recovery
never loses an acknowledged admission.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import struct
import zlib
from typing import TYPE_CHECKING, Iterator

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.snn_engine import SNNServeEngine
    from repro_torch.serve.streaming import StreamSessionManager

__all__ = [
    "Journal",
    "JournalRecord",
    "JournalCorruptError",
    "read_records",
    "recover",
    "RecoveredState",
    "SessionRecovery",
]

_MAGIC = b"NRAWAL01"
_HDR = struct.Struct("<II")  # payload_len, crc32(payload)


class JournalCorruptError(RuntimeError):
    """A journal segment failed integrity verification somewhere other
    than the repairable tail -- bit rot or truncation of an *interior*
    segment.  Refusing beats silently recovering half a serve history."""


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One replayed record: ``lsn`` is its 0-based global position."""

    lsn: int
    kind: str
    fields: dict
    arrays: dict  # name -> np.ndarray


def _encode(kind: str, fields: dict, arrays: dict | None) -> bytes:
    arrays = arrays or {}
    blobs = []
    meta_arrays = []
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        meta_arrays.append([name, str(a.dtype), list(a.shape)])
        blobs.append(a.tobytes())
    meta = json.dumps(
        {"kind": kind, "fields": fields, "arrays": meta_arrays}, separators=(",", ":")
    ).encode()
    payload = struct.pack("<I", len(meta)) + meta + b"".join(blobs)
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def _decode(lsn: int, payload: bytes) -> JournalRecord:
    (meta_len,) = struct.unpack_from("<I", payload, 0)
    meta = json.loads(payload[4 : 4 + meta_len].decode())
    arrays, off = {}, 4 + meta_len
    for name, dtype, shape in meta["arrays"]:
        n = int(np.dtype(dtype).itemsize * int(np.prod(shape, dtype=np.int64)))
        arrays[name] = np.frombuffer(payload[off : off + n], dtype=dtype).reshape(shape)
        off += n
    return JournalRecord(lsn=lsn, kind=meta["kind"], fields=meta["fields"], arrays=arrays)


def _scan_segment(path: pathlib.Path) -> tuple[int, int]:
    """Count the whole, CRC-valid frames in a segment.

    Returns ``(n_records, valid_end_offset)`` where ``valid_end_offset``
    is the byte offset just past the last valid frame (the truncation
    point for tail repair).  A bad magic counts as zero valid bytes past
    the header probe.
    """
    data = path.read_bytes()
    if data[: len(_MAGIC)] != _MAGIC:
        return 0, 0
    off, n = len(_MAGIC), 0
    while off + _HDR.size <= len(data):
        length, crc = _HDR.unpack_from(data, off)
        end = off + _HDR.size + length
        if end > len(data):
            break  # torn: header landed, payload did not
        payload = data[off + _HDR.size : end]
        if zlib.crc32(payload) != crc:
            break  # torn or rotted frame: stop at the last valid one
        off, n = end, n + 1
    return n, off


class Journal:
    """Append-only WAL over ``<root>/segment_%08d.wal`` files.

    ``fsync_every`` batches durability (every Nth append fsyncs; 1 =
    synchronous WAL); ``segment_bytes`` caps a segment before rotation.
    Reopening an existing root repairs the last segment's torn tail and
    resumes appending after it.  ``faults`` threads the chaos injector's
    ``journal`` site through ``append`` (torn-frame writes).
    """

    def __init__(
        self,
        root: "str | pathlib.Path",
        *,
        segment_bytes: int = 4 << 20,
        fsync_every: int = 16,
        faults: "FaultInjector | None" = None,
    ):
        if segment_bytes < len(_MAGIC) + _HDR.size:
            raise ValueError(f"segment_bytes too small: {segment_bytes}")
        if fsync_every < 1:
            raise ValueError(f"fsync_every must be >= 1, got {fsync_every}")
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = segment_bytes
        self.fsync_every = fsync_every
        self.faults = faults
        self._pending = 0
        segs = self._segments()
        self.lsn = 0  # next record's global position
        if segs:
            for p in segs[:-1]:
                n, end = _scan_segment(p)
                if end != p.stat().st_size:
                    raise JournalCorruptError(
                        f"journal segment {p.name} is damaged at byte {end} "
                        "but is not the tail segment; refusing to append"
                    )
                self.lsn += n
            n, end = _scan_segment(segs[-1])
            if end < segs[-1].stat().st_size:  # torn tail from a crash: repair
                with open(segs[-1], "r+b") as f:
                    f.truncate(end)
            self.lsn += n
            self._seg_index = int(segs[-1].stem.split("_")[1])
            if end >= len(_MAGIC):
                self._f = open(segs[-1], "ab")
            else:
                # the crash tore the magic itself: rewrite the segment
                # header, or every frame appended after the repair would
                # land in an unparseable file
                self._f = self._new_segment(self._seg_index)
        else:
            self._seg_index = 0
            self._f = self._new_segment(0)

    def _segments(self) -> list[pathlib.Path]:
        return sorted(self.root.glob("segment_*.wal"))

    def _new_segment(self, index: int):
        path = self.root / f"segment_{index:08d}.wal"
        f = open(path, "wb")
        f.write(_MAGIC)
        f.flush()
        os.fsync(f.fileno())
        dfd = os.open(self.root, os.O_RDONLY)  # directory entry must survive too
        os.fsync(dfd)
        os.close(dfd)
        return f

    # ------------------------------------------------------------------ write
    def append(self, kind: str, arrays: dict | None = None, **fields) -> int:
        """Append one record; returns its lsn.  Durable after the next
        batched fsync (or immediately with ``fsync_every=1``)."""
        frame = _encode(kind, fields, arrays)
        if self.faults is not None:
            torn = self.faults.torn_journal_bytes(frame)
            if torn is not None:
                from repro_torch.serve.faults import SimulatedKill

                self._f.write(torn)
                self._f.flush()
                os.fsync(self._f.fileno())
                raise SimulatedKill("injected: process killed mid-journal-append")
        if self._f.tell() + len(frame) > self.segment_bytes and self._f.tell() > len(_MAGIC):
            self.rotate()
        self._f.write(frame)
        self._pending += 1
        if self._pending >= self.fsync_every:
            self.flush()
        lsn, self.lsn = self.lsn, self.lsn + 1
        return lsn

    def flush(self, fsync: bool = True) -> None:
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())
        self._pending = 0

    def rotate(self) -> None:
        """Seal the active segment (flush + fsync) and start the next.
        The new segment is durable (file + directory entry fsynced)
        before any frame lands in it."""
        self.flush()
        self._f.close()
        self._seg_index += 1
        self._f = self._new_segment(self._seg_index)

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------- read
    def records(self) -> "Iterator[JournalRecord]":
        self.flush()
        return read_records(self.root)


def read_records(root: "str | pathlib.Path") -> Iterator[JournalRecord]:
    """Replay every whole, CRC-valid record in lsn order.

    A torn tail in the *last* segment ends iteration (that is the
    repairable crash case); damage anywhere else raises
    :class:`JournalCorruptError`.
    """
    root = pathlib.Path(root)
    segs = sorted(root.glob("segment_*.wal"))
    lsn = 0
    for si, path in enumerate(segs):
        last = si == len(segs) - 1
        data = path.read_bytes()
        if data[: len(_MAGIC)] != _MAGIC:
            if last and len(data) < len(_MAGIC):
                return  # crashed during segment creation: empty tail
            raise JournalCorruptError(f"journal segment {path.name} has a bad magic")
        off = len(_MAGIC)
        while off + _HDR.size <= len(data):
            length, crc = _HDR.unpack_from(data, off)
            end = off + _HDR.size + length
            if end > len(data) or zlib.crc32(data[off + _HDR.size : end]) != crc:
                if last:
                    return  # torn tail: everything before it already yielded
                raise JournalCorruptError(
                    f"journal segment {path.name} is damaged at byte {off} "
                    "but is not the tail segment"
                )
            yield _decode(lsn, data[off + _HDR.size : end])
            off, lsn = end, lsn + 1
        if off < len(data) and not last:
            raise JournalCorruptError(
                f"journal segment {path.name} has {len(data) - off} trailing "
                "bytes but is not the tail segment"
            )


# --------------------------------------------------------------------- replay
@dataclasses.dataclass
class SessionRecovery:
    """What the journal knows about one live stream session."""

    sid: str
    config: dict  # StreamConfig field overrides captured at open
    feeds: list  # [(start_step, chunk ndarray), ...] in feed order
    ckpt_t: int | None = None  # latest evict-time checkpoint watermark

    @property
    def fed_steps(self) -> int:
        if not self.feeds:
            return self.ckpt_t or 0
        start, chunk = self.feeds[-1]
        return start + chunk.shape[0]


@dataclasses.dataclass
class RecoveredState:
    """The journal's replayed view of serve state at crash time.

    ``requests`` are admissions without a terminal record -- they restart
    from scratch (serving is a pure function of the raster, so re-running
    is bit-exact; completion callbacks from the dead process are gone,
    which is why the HTTP layer answers 503 + ``Retry-After`` during
    recovery).  ``sessions`` are opens without a close -- they restore
    from their latest checkpoint and re-feed the journaled suffix.
    """

    requests: list  # [{"uid", "raster", "priority", "tenant", "deadline_s"}, ...]
    sessions: dict  # sid -> SessionRecovery
    n_records: int
    n_done: int  # terminal records seen (for reporting)

    def apply(
        self,
        engine: "SNNServeEngine",
        manager: "StreamSessionManager | None" = None,
        checkpoint_dir: "str | pathlib.Path | None" = None,
    ) -> dict:
        """Rebuild live state on a fresh engine/manager.

        Outstanding requests are resubmitted (same uid/priority/tenant;
        the resubmission is journaled again, which is safe -- replay keys
        by uid).  Live sessions are re-opened, restored from their latest
        checkpoint when one exists (CRC-verified through the manager's
        own restore path), and re-fed every journaled step beyond the
        checkpoint watermark.  Returns a summary dict for logs/metrics.
        """
        from repro_torch.serve.snn_engine import SNNRequest

        for r in self.requests:
            engine.submit(
                SNNRequest(
                    uid=r["uid"],
                    raster=r["raster"],
                    priority=r["priority"],
                    tenant=r["tenant"],
                    deadline_s=r.get("deadline_s"),
                )
            )
        refed_sessions = 0
        refed_steps = 0
        if self.sessions and manager is None:
            raise ValueError(
                f"journal has {len(self.sessions)} live sessions but no "
                "StreamSessionManager was provided to apply() them to"
            )
        for sid, rec in self.sessions.items():
            s = manager.open(sid, **rec.config)
            f0 = 0
            if rec.ckpt_t is not None:
                # a checkpoint exists for this stream: restore it, CRC-
                # verified.  The checkpoint's own user_state watermark wins
                # over the journaled one -- a crash between an evict's save
                # and its journal record leaves the checkpoint one step
                # ahead, and newer coverage is strictly safe (the journaled
                # feeds only ever get *pruned* below the older watermark).
                if manager.checkpoint_dir is None:
                    raise ValueError(
                        f"session {sid!r} has an evict-time checkpoint in the "
                        "journal but the recovery manager has no checkpoint_dir"
                    )
                tree, user = manager._ckpt(sid).restore(
                    {
                        "carry": manager._carry_template(),
                        "tail": np.zeros((0, 1), np.int64),
                    }
                )
                f0 = int(user["t_total"])
                s.carry = list(tree["carry"])
                tail = np.asarray(tree["tail"], np.int64)
                s._tail = tail if tail.size else None
                s.t_total = f0
                s.fed_steps = f0
                s.n_readouts = int(user.get("n_readouts", 0))
                s.n_chunks = int(user.get("n_chunks", 0))
                counts = user.get("counts_total") or []
                s.counts_total = np.asarray(counts, np.int64) if len(counts) else None
                s.n_restores += 1
            # Re-feed the journaled suffix beyond the checkpoint watermark.
            # Assemble it by *global step offset*, not record by record: a
            # previous recovery re-journaled the same steps it re-fed, so
            # records may overlap -- identical content at the same offsets
            # (the stream is append-only), deduplicated by construction.
            suffix = [
                (start, chunk)
                for start, chunk in rec.feeds
                if start + chunk.shape[0] > f0
            ]
            if suffix:
                end = max(st + ch.shape[0] for st, ch in suffix)
                n_in = suffix[0][1].shape[1]
                buf = np.zeros((end - f0, n_in), suffix[0][1].dtype)
                covered = np.zeros(end - f0, bool)
                for st, ch in suffix:
                    lo = max(st, f0)
                    buf[lo - f0 : st + ch.shape[0] - f0] = ch[lo - st :]
                    covered[lo - f0 : st + ch.shape[0] - f0] = True
                if not covered.all():
                    raise JournalCorruptError(
                        f"session {sid!r}: journaled feeds leave a gap in "
                        f"steps [{f0}, {end}) -- cannot reconstruct the stream"
                    )
                manager.feed(sid, buf)
                refed_steps += buf.shape[0]
            refed_sessions += 1
        return {
            "requests_resubmitted": len(self.requests),
            "sessions_reopened": refed_sessions,
            "steps_refed": refed_steps,
            "records_replayed": self.n_records,
        }


def recover(
    journal_root: "str | pathlib.Path",
    checkpoint_dir: "str | pathlib.Path | None" = None,
) -> RecoveredState:
    """Fold the journal into a :class:`RecoveredState`.

    Pure replay -- touches no engine.  Folding is keyed by uid/sid, so
    replaying any prefix and then replaying again (the double-crash case)
    converges on the same state: a second ``submit`` for a known uid
    refreshes rather than duplicates, a ``done`` removes exactly one
    outstanding entry, a re-``open`` of a still-live sid merges into its
    fold, and overlapping re-fed steps deduplicate by global offset.
    """
    outstanding: dict = {}
    sessions: dict[str, SessionRecovery] = {}
    n_records = n_done = 0
    for rec in read_records(journal_root):
        n_records += 1
        k = rec.kind
        if k == "submit":
            outstanding[rec.fields["uid"]] = {
                "uid": rec.fields["uid"],
                "raster": np.asarray(rec.arrays["raster"]),
                "priority": int(rec.fields.get("priority", 1)),
                "tenant": rec.fields.get("tenant", "default"),
                "deadline_s": rec.fields.get("deadline_s"),
            }
        elif k == "done":
            outstanding.pop(rec.fields["uid"], None)
            n_done += 1
        elif k == "session_open":
            sid = rec.fields["sid"]
            if sid in sessions:
                # a recovery's re-open of a still-live session: keep the
                # accumulated feeds/checkpoint fold (resetting would orphan
                # the pre-crash history a *second* crash still needs)
                sessions[sid].config.update(rec.fields.get("config", {}))
            else:
                sessions[sid] = SessionRecovery(
                    sid=sid, config=dict(rec.fields.get("config", {})), feeds=[]
                )
        elif k == "feed":
            s = sessions.get(rec.fields["sid"])
            if s is not None:
                s.feeds.append(
                    (int(rec.fields["start"]), np.asarray(rec.arrays["chunk"]))
                )
        elif k == "evict":
            s = sessions.get(rec.fields["sid"])
            if s is not None:
                s.ckpt_t = int(rec.fields["t_total"])
                # feeds fully inside the checkpoint can never be re-fed:
                # drop them so recovery memory stays bounded
                s.feeds = [
                    (st, ch) for st, ch in s.feeds if st + ch.shape[0] > s.ckpt_t
                ]
        elif k == "session_close":
            sessions.pop(rec.fields["sid"], None)
            n_done += 1
        # unknown kinds are skipped: forward compatibility with future
        # record types costs nothing here
    return RecoveredState(
        requests=list(outstanding.values()),
        sessions=sessions,
        n_records=n_records,
        n_done=n_done,
    )
