"""Frozen operation and byte counts of the port's SNN kernels, and the H100's peaks.

The peaks are NVIDIA's published dense figures for one H100 SXM at its full
700 W; a roofline share is stated against them with the card's power limit
beside it.  Each count reads every input once and writes every output once,
whatever the kernel reads again, and counts the work these inputs need (for
``sparse_accum``: the events present, not the budget of slots).  Operations are
the dense-equivalent integer operations, one fixed count whatever route a
kernel takes.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12  # HBM3
INT8_TC_OPS_S = 1979e12  # int8 tensor cores, dense
INT32 = 4  # bytes of an int32 element


def bound_s(n_bytes: float, ops: float) -> float:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the int8 tensor-core rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_S, ops / INT8_TC_OPS_S)


def spike_matmul_work(P: int, M: int, K: int, N: int, shared_spikes: bool) -> tuple[int, int]:
    """``spike_matmul`` of [M, K] (shared) or [P, M, K] spikes by [P, K, N]
    weights into [P, M, N] int32: (bytes, operations)."""
    spikes = M * K if shared_spikes else P * M * K
    n_bytes = INT32 * (spikes + P * K * N + P * M * N)
    return n_bytes, 2 * P * M * K * N


def lif_scan_work(P: int, T: int, B: int, N: int, taps: int) -> tuple[int, int]:
    """``lif_scan`` of [P, T, B, N] currents with one theta and decay register
    per candidate: currents in, spikes and the final membrane out; per element
    and step a saturating add, compare, subtract, select and ``taps``
    shift-adds (``taps`` summed over the candidates, each counted once)."""
    n_bytes = INT32 * (2 * P * T * B * N + P * B * N + 2 * P)
    ops = T * B * N * (12 * P + 2 * taps)
    return n_bytes, ops


def sparse_accum_work(rows: int, events: int, n_in: int, N: int) -> tuple[int, int]:
    """``sparse_accum`` over ``rows`` event rows holding ``events`` events in
    all: each event's value and index, the [n_in, N] weight table once, the
    [rows, N] int32 output; a multiply-add per event and output column."""
    n_bytes = 2 * INT32 * events + INT32 * n_in * N + INT32 * rows * N
    return n_bytes, 2 * events * N


def net_ops_per_sample(layers: list[dict], T: int) -> int:
    """Dense-equivalent integer operations of one candidate on one sample:
    a multiply-add per synapse and step, and the ATA-F self-weight's
    multiply-add per neuron and step."""
    ops = 0
    for layer in layers:
        ops += 2 * T * layer["n_in"] * layer["n_out"]
        if layer["topology"] == "ata_f":
            ops += 2 * T * layer["n_out"]
    return ops


def event_budget(max_active: int, n_in: int, multiple: int = 16) -> int:
    """The event path's budget for a layer: the most active channels of any
    row, rounded up to ``multiple``, at most ``n_in``."""
    return min(n_in, max(multiple, -(-max_active // multiple) * multiple))


def takes_sparse_path(max_active: int, n_in: int, dense_threshold: float = 0.34) -> bool:
    """Whether the event path runs a layer through ``sparse_accum``: its
    budget is at most ``dense_threshold`` of the layer's inputs."""
    return event_budget(max_active, n_in) <= dense_threshold * n_in
