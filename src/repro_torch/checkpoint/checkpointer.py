"""Checkpointing with atomic commit (port of ``repro/checkpoint/checkpointer.py``).

Layout (one directory per step):

    <root>/step_00001230.tmp/       -- written first
        arrays.npz                  -- flattened leaves (key = tree path)
        manifest.json               -- leaf paths, shapes, dtypes, CRCs, user state
    <root>/step_00001230/           -- atomic rename after fsync
    <root>/LATEST                   -- text file, atomically replaced

Trees are nested dicts, lists, tuples and named tuples whose leaves are
torch tensors, numpy arrays or Python scalars; every leaf crosses through
numpy (a tensor on the card is copied to the host when the save is called).
The port walks its trees itself, with the same leaf keys as the JAX
version (dict keys, sequence indices and named-tuple fields joined by
``::``), so a checkpoint written by either package has the same layout.

Saving snapshots the tree to the host synchronously, then serialises and
commits on a background thread (``blocking=True`` commits before
returning); ``wait()`` joins before the next save or shutdown.  Restore
verifies every leaf against the CRC recorded at save time.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
import zlib

import numpy as np
import torch

__all__ = ["Checkpointer", "CheckpointCorruptError", "latest_step"]

_SEP = "::"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint on disk failed integrity verification.

    Raised by :meth:`Checkpointer.restore` when the manifest is unreadable,
    the array container is damaged, or a leaf's content no longer matches
    its recorded CRC -- a clear refusal instead of silently handing back
    garbage state.
    """


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``(key, child)`` pairs of an inner node in the JAX tree order (dict
    keys sorted), or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaf_paths(tree, prefix=()):
    """``(path, leaf)`` for every leaf of ``tree``, depth first."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from _leaf_paths(child, prefix + (key,))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> dict[str, np.ndarray]:
    return {_SEP.join(path): _to_numpy(leaf) for path, leaf in _leaf_paths(tree)}


def _rebuild(template, load, prefix=()):
    """``template``'s structure with each leaf replaced by ``load(key,
    template_leaf)``."""
    kids = _children(template)
    if kids is None:
        return load(_SEP.join(prefix), template)
    values = [_rebuild(child, load, prefix + (key,)) for key, child in kids]
    if isinstance(template, dict):
        return dict(zip((k for k, _ in kids), values))
    if _is_namedtuple(template):
        return type(template)(*values)
    return type(template)(values)


def latest_step(root: str | pathlib.Path) -> int | None:
    f = pathlib.Path(root) / "LATEST"
    if not f.exists():
        return None
    return int(f.read_text().strip())


def _fsync_path(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Checkpointer:
    """Atomic, CRC-verified checkpoints under ``root``, keeping the newest
    ``keep`` steps.

    ``faults`` threads the chaos injector's ``checkpoint`` site between
    the commit's file writes (:mod:`repro_torch.serve.faults`): a fire
    there is a torn write, which the atomic commit keeps invisible -- the
    half-written ``.tmp`` directory is never renamed, so readers only ever
    see whole, fsynced checkpoints."""

    def __init__(self, root: str | pathlib.Path, keep: int = 3, faults=None):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.faults = faults
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, user_state: dict | None = None, *, blocking: bool = False):
        """Snapshot to host, then commit (on a background thread unless
        ``blocking``)."""
        self.wait()
        flat = _flatten_with_paths(tree)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            # content CRCs: npz stores raw .npy members, so a flipped byte
            # would otherwise decode into a plausible-looking garbage array
            "crc32": {
                k: zlib.crc32(np.ascontiguousarray(v).tobytes()) for k, v in flat.items()
            },
            "user_state": user_state or {},
            "time": time.time(),
        }

        def commit():
            # write tmp -> fsync every file and the tmp directory -> rename:
            # a crash at any point leaves either the previous checkpoint or a
            # stray .tmp that restore never looks at
            try:
                tmp = self.root / f"step_{step:08d}.tmp"
                final = self.root / f"step_{step:08d}"
                tmp.mkdir(parents=True, exist_ok=True)
                np.savez(tmp / "arrays.npz", **flat)
                _fsync_path(tmp / "arrays.npz")
                if self.faults is not None:
                    self.faults.on_checkpoint_write()  # chaos: torn write
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                _fsync_path(tmp / "manifest.json")
                _fsync_path(tmp)
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)
                _fsync_path(self.root)  # the rename itself must survive
                latest = self.root / "LATEST.tmp"
                latest.write_text(str(step))
                _fsync_path(latest)
                os.replace(latest, self.root / "LATEST")
                self._gc()
            except Exception as e:  # surfaced on the next wait()
                # a BaseException (a simulated kill, interpreter shutdown)
                # propagates: a killed process cannot stash its own failure
                self._error = e

        if blocking:
            commit()
            self.wait()
        else:
            self._thread = threading.Thread(target=commit, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err}") from err

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.root.glob("step_*") if not p.name.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def restore(self, template, step: int | None = None):
        """Rebuild ``template``'s tree from disk; returns ``(tree, user_state)``.

        A leaf whose template is a tensor comes back as a tensor on the
        template's device; every other leaf as a numpy array.  Every leaf is
        checked against the CRC recorded at save time; a mismatch, or an
        unreadable manifest or container, raises
        :class:`CheckpointCorruptError`.
        """
        self.wait()
        step = step if step is not None else latest_step(self.root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = self.root / f"step_{step:08d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            arrays = np.load(d / "arrays.npz")
        except FileNotFoundError:
            raise
        except Exception as e:
            raise CheckpointCorruptError(
                f"checkpoint step {step} under {self.root} is unreadable "
                f"({type(e).__name__}: {e}); refusing to restore"
            ) from e
        crcs = manifest.get("crc32", {})

        def load(key, like):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key!r} (step {step})")
            try:
                leaf = arrays[key]
            except Exception as e:
                raise CheckpointCorruptError(
                    f"checkpoint step {step}: leaf {key!r} failed to decode "
                    f"({type(e).__name__}: {e}); refusing to restore"
                ) from e
            if key in crcs and zlib.crc32(np.ascontiguousarray(leaf).tobytes()) != crcs[key]:
                raise CheckpointCorruptError(
                    f"checkpoint step {step}: leaf {key!r} failed CRC "
                    "verification (content does not match what was saved); "
                    "refusing to restore"
                )
            if isinstance(like, torch.Tensor):
                return torch.from_numpy(np.array(leaf)).to(like.device)
            return leaf

        return _rebuild(template, load), manifest["user_state"]
