"""What a kernel call computes, reported to the counters that are listening.

A hand-written kernel is a ctypes launch that no ``TorchDispatchMode``
sees, and on the ``meta`` device it is only an allocation.  Each wrapper
therefore reports its call's work through :func:`kernel` -- on ``cuda``
where it launches, on ``meta`` where it allocates its output, and on the
CPU around its plain version -- so that a counter attributes the call's
operations and bytes to the kernel and not to whatever ops run inside the
block.  Nothing listens unless a counter is entered with :func:`listening`.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import numpy as np

__all__ = ["kernel", "listening", "flash_pairs"]

_SINKS: ContextVar[tuple] = ContextVar("kernel_work_sinks", default=())


@contextlib.contextmanager
def listening(sink):
    """Report every kernel call made inside the block to ``sink``: its
    ``kernel_begin(name, flops, nbytes, operands)`` before the call's body
    (the output's allocation and the launch, or the plain version) and
    ``kernel_end()`` after it."""
    token = _SINKS.set(_SINKS.get() + (sink,))
    try:
        yield sink
    finally:
        _SINKS.reset(token)


@contextlib.contextmanager
def kernel(name: str, flops: float, nbytes: float, operands: tuple = ()):
    """One kernel call on ``operands`` of ``flops`` operations that reads its
    inputs and writes its outputs once (``nbytes``)."""
    sinks = _SINKS.get()
    for s in sinks:
        s.kernel_begin(name, flops, nbytes, operands)
    try:
        yield
    finally:
        for s in reversed(sinks):
            s.kernel_end()


def flash_pairs(Sq: int, Sk: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs attention computes over positions 0..Sq-1 and
    0..Sk-1: key j <= query i where causal, i - j < window where windowed."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, dtype=np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())
