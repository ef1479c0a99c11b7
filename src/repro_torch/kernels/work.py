"""What a kernel call computes, and the program's spans and counters, reported
to the sinks that are listening.

A hand-written kernel is a ctypes launch that no ``TorchDispatchMode``
sees, and on the ``meta`` device it is only an allocation.  Each wrapper
therefore reports its call's work through :func:`kernel` -- on ``cuda``
where it launches, on ``meta`` where it allocates its output, and on the
CPU around its plain version -- so that a counter attributes the call's
operations and bytes to the kernel and not to whatever ops run inside the
block.  The program marks its own stages with :func:`span` (or
:func:`spanned`, each step of an iterator); a kernel call is a span too,
named after the kernel.  Nothing listens unless a sink is entered with
:func:`listening` (or a :class:`Recorder` is entered).  With nothing
listening, :func:`span` and :func:`kernel` read one ``ContextVar`` and
return the shared no-op :data:`OFF`: no generator, no record and no clock
read.

A sink takes what it defines: ``kernel_begin(name, flops, nbytes,
operands)`` / ``kernel_end()``, ``span_begin(name)`` / ``span_end()`` and
``device_counter(name, device)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from contextvars import ContextVar

import numpy as np
import torch

__all__ = [
    "kernel",
    "span",
    "spanned",
    "device_counter",
    "listening",
    "Recorder",
    "Span",
    "OFF",
    "DEVICE_COUNTERS",
    "flash_pairs",
]

_SINKS: ContextVar[tuple] = ContextVar("kernel_work_sinks", default=())

# Counters a kernel keeps on the device, by name, and the parts of each
# (an int64 buffer of one element a part): csrc/spike_matmul.cu's
# multiply-adds by the route they ran on, those of an ATA-T layer's
# recurrence apart from the rest
DEVICE_COUNTERS = {
    "spike_matmul.macs": ("tensor", "planes", "cuda_cores"),
    "spike_matmul.rec_macs": ("tensor", "planes", "cuda_cores"),
}


class _Off:
    """A ``with`` block that does nothing: what :func:`span` and
    :func:`kernel` give while no sink listens."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Block:
    """A span, or a kernel call (``work`` = (flops, nbytes, operands)), for
    the sinks listening when it was made."""

    __slots__ = ("sinks", "name", "work")

    def __init__(self, sinks, name, work=None):
        self.sinks, self.name, self.work = sinks, name, work

    def __enter__(self):
        for s in self.sinks:
            if self.work is not None and hasattr(s, "kernel_begin"):
                s.kernel_begin(self.name, *self.work)
            if hasattr(s, "span_begin"):
                s.span_begin(self.name)

    def __exit__(self, *exc):
        for s in reversed(self.sinks):
            if hasattr(s, "span_end"):
                s.span_end()
            if self.work is not None and hasattr(s, "kernel_end"):
                s.kernel_end()
        return False


@contextlib.contextmanager
def listening(sink):
    """Report every kernel call and span made inside the block to
    ``sink``, as far as it defines the methods above: ``kernel_begin``
    before a kernel call's body (the output's allocation and the launch,
    or the plain version) and ``kernel_end()`` after it."""
    token = _SINKS.set(_SINKS.get() + (sink,))
    try:
        yield sink
    finally:
        _SINKS.reset(token)


def kernel(name: str, flops: float, nbytes: float, operands: tuple = ()):
    """One kernel call on ``operands`` of ``flops`` operations that reads its
    inputs and writes its outputs once (``nbytes``); to a sink that takes
    spans, also a span named ``name``."""
    sinks = _SINKS.get()
    if not sinks:
        return OFF
    return _Block(sinks, name, (flops, nbytes, operands))


def span(name: str):
    """A stage of the program, from entering the ``with`` block to leaving it."""
    sinks = _SINKS.get()
    if not sinks:
        return OFF
    return _Block(sinks, name)


_END = object()


def spanned(items, name: str):
    """Iterate ``items`` with each step (its ``next()``, the last one that
    ends the iteration too) inside the span ``name``."""
    it = iter(items)
    while True:
        with span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def device_counter(name: str, device):
    """The int64 buffer of :data:`DEVICE_COUNTERS` ``name`` on ``device`` that
    a listening sink keeps, for a kernel to add its counts into; None where
    no sink keeps one there (the kernel then counts nothing)."""
    for s in _SINKS.get():
        if hasattr(s, "device_counter"):
            buf = s.device_counter(name, device)
            if buf is not None:
                return buf
    return None


@dataclasses.dataclass
class Span:
    """One span as a :class:`Recorder` keeps it: its host times in
    ``time.time_ns()`` (``end_ns`` 0 while open) and the index of its parent
    in the recorder's ``spans`` (-1 for an outermost span)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int


class Recorder:
    """A sink that keeps every span and counter in memory until it is read.

    Span times are ``time.time_ns()``, the clock that ``torch.profiler``'s
    device events carry, so a device event can be placed inside the host
    spans.  Entered (``with Recorder("cuda") as rec:``), it listens; on a
    card it also allocates the buffers of :data:`DEVICE_COUNTERS` once and,
    on leaving, reads each once into the counters ``<name>.<part>``: nothing
    in between waits for the card on its account.
    """

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}
        self._open: list[int] = []
        self._buffers: dict[str, torch.Tensor] = {}
        self._token = None

    def __enter__(self):
        if self.device is not None and self.device.type == "cuda":
            self._buffers = {
                name: torch.zeros(len(parts), dtype=torch.int64, device=self.device)
                for name, parts in DEVICE_COUNTERS.items()
            }
        self._token = _SINKS.set(_SINKS.get() + (self,))
        return self

    def __exit__(self, *exc):
        _SINKS.reset(self._token)
        for name, buf in self._buffers.items():
            for part, n in zip(DEVICE_COUNTERS[name], buf.tolist()):
                key = f"{name}.{part}"
                self.counts[key] = self.counts.get(key, 0) + n
        self._buffers = {}
        return False

    def span_begin(self, name: str) -> None:
        i = len(self.spans)
        parent = self._open[-1] if self._open else -1
        self.spans.append(Span(name, time.time_ns(), 0, parent))
        self._open.append(i)

    def span_end(self) -> None:
        self.spans[self._open.pop()].end_ns = time.time_ns()

    def device_counter(self, name: str, device):
        buf = self._buffers.get(name)
        return buf if buf is not None and buf.device == torch.device(device) else None


def flash_pairs(Sq: int, Sk: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs attention computes over positions 0..Sq-1 and
    0..Sk-1: key j <= query i where causal, i - j < window where windowed."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, dtype=np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())
