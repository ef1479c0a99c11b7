"""Exact int32 spike x quantized-weight product: the ``spike_matmul`` kernel.

Port of ``repro/kernels/quant_matmul/spike_matmul.py``.  On the card this
wrapper is the only exact int32 product of the port: PyTorch's CUDA matmul
has no int32 path and ``torch._int_mm`` takes int8 only, so phase A
(``int_phase_a``), the ATA_T recurrence, ``spike_integrate`` and the dense
fallbacks all come here.  The CUDA source is ``csrc/spike_matmul.cu``.

The kernel runs on the int8 tensor cores wherever the block's weights fit
int8 (weights of at most 8 bits): a 16-row strip's 256-deep K chunk in one
pass when its spikes fit int8 (binary spikes), else in up to four byte-plane
passes -- exact for any int32 spikes.  Weights that fit int16 but not int8
(9 to 16 bits) run there too, as two weight byte planes (w = 2**8 hi + lo,
one pass each) for a chunk whose spikes fit int8, where the high plane fits
the block's staging area (:func:`planes_fit`: K up to about 1024).  Weights
beyond int16, and graded spikes times weights beyond int8, run on the CUDA
cores.  The routes are decided on the device from the block's own values;
:func:`plan` picks the block's columns, the number of persistent blocks and
the shared memory from the shape alone.

A leading candidate axis on either operand ([P, M, K] @ [K, N], [M, K] @
[P, K, N] or [P, M, K] @ [P, K, N] -> [P, M, N]) runs the P products in one
launch: the population sweep of the design-space exploration scores P
precision candidates at once, on one shared raster (layer 0) or on each
candidate's own spikes (later layers).

For a CPU tensor the wrapper runs :func:`spike_matmul_plain` (int32
``torch.matmul``, which wraps mod 2**32 like the JAX product); for a CUDA
tensor it launches the kernel or raises.  Each call reports its 2 P M K N
operations and its bytes (each operand read once, the output written once)
through :func:`~repro_torch.kernels.work.kernel`.  While a sink keeps the
``spike_matmul.macs`` device counter (:func:`~repro_torch.kernels.work.
device_counter`), the kernel adds to it its P M K N multiply-adds by the
route each tile -- one 16-row strip by one 256-deep K chunk by one block of
columns -- ran: one tensor-core pass, byte planes (of spikes or of
weights), or the CUDA cores;
otherwise it gets a null pointer and counts nothing.  A caller names another
counter of the same parts with ``counter`` (an ATA-T layer's recurrence
counts under ``spike_matmul.rec_macs``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build, work

__all__ = [
    "SMPlan", "plan", "planes_fit", "spike_matmul", "spike_matmul_plain", "spike_integrate"
]

# The tiles of csrc/spike_matmul.cu, and the card's SM count (H100 SXM)
STRIP = 16  # rows of s a warp takes at a time (the mma's M)
CHUNK = 256  # K of one int8 chunk
WARPS = 8  # warps per block
MAX_BN = 128  # output columns per block
ROW_PAD = 16  # bytes after each int8 weight column in shared memory
SMEM_CAP = 227 * 1024  # shared memory a block may take (one block an SM)
N_SMS = 132
BATCHED_BN = (16, MAX_BN)  # the columns of the candidate-axis kernel's blocks


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class SMPlan:
    """How one call runs: ``kind`` ("tensor": int8 tensor cores where the
    values fit, or "simt": CUDA cores throughout), the output columns of a
    block (``bn``), the CUDA grid (persistent blocks along M, column tiles)
    and the shared-memory bytes of the block's int8 weights."""

    kind: str
    bn: int
    grid: tuple[int, int]
    smem: int


def weight_row_bytes(K: int) -> int:
    """Shared-memory bytes of one int8 weight column: K rounded up to whole
    256-deep chunks, at least one (zero-filled), padded."""
    return max(1, _cdiv(K, CHUNK)) * CHUNK + ROW_PAD


def block_smem(K: int, bn: int) -> int:
    """Shared-memory bytes of a tensor-core block: its int8 weights and one
    256-row piece of int32 weights staged on the way (rows padded by 16)."""
    return bn * weight_row_bytes(K) + CHUNK * (4 * bn + ROW_PAD)


def planes_fit(K: int, bn: int) -> bool:
    """Whether a tensor-core block of ``bn`` columns has room for the high
    byte plane of int16 weights: it takes over the staging area of
    :func:`block_smem` once the weights are narrowed."""
    return bn * weight_row_bytes(K) <= CHUNK * (4 * bn + ROW_PAD)


def plan(M: int, K: int, N: int, batch: int = 1) -> SMPlan:
    """The configuration for ``batch`` [M, K] x [K, N] products in one call; a
    function of the shape only.  A block covers N rounded up to a power of
    two, at most 128 columns, halved while its shared memory
    (:func:`block_smem`) exceeds the budget; where even 8 columns do not fit,
    the call runs on the CUDA cores.  One block an SM, each taking a
    contiguous range of 16-row strips, so M sets no grid limit; the products
    of a batch share the SMs (grid.z is the candidate).  A batch of more
    than one product has its own kernel, built for 16 and 128 columns only:
    16 for N <= 16, else 128, never narrowed (the CUDA cores take what does
    not fit)."""
    if batch > 1:
        bn = BATCHED_BN[0] if N <= BATCHED_BN[0] else MAX_BN
    else:
        bn = 8
        while bn < min(N, MAX_BN):
            bn *= 2
        while bn > 8 and block_smem(K, bn) > SMEM_CAP:
            bn //= 2
    kind = "tensor" if block_smem(K, bn) <= SMEM_CAP else "simt"
    if kind == "simt":
        bn = MAX_BN
    col_tiles = max(1, _cdiv(N, bn))
    blocks = max(1, min(_cdiv(M, STRIP), _cdiv(N_SMS, col_tiles * max(1, batch))))
    smem = block_smem(K, bn) if kind == "tensor" else 0
    return SMPlan(kind, bn, (blocks, col_tiles), smem)


def spike_matmul_plain(s: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``s @ w_q`` in int32 with mod-2**32 wraparound (either
    operand may carry a leading candidate axis, broadcast like ``matmul``).

    CPU: int32 ``torch.matmul``.  CUDA has no integer GEMM, so there the
    same sum is taken as K rank-1 updates in int32 (used only to check the
    kernel on the card).
    """
    if s.device.type != "cuda":
        return torch.matmul(s.to(torch.int32), w_q.to(torch.int32))
    shape = torch.broadcast_shapes(s.shape[:-2], w_q.shape[:-2]) + (s.shape[-2], w_q.shape[-1])
    out = torch.zeros(shape, dtype=torch.int32, device=s.device)
    for k in range(s.shape[-1]):
        out += s[..., :, k, None] * w_q[..., k, None, :]
    return out


def _operands(s: torch.Tensor, w_q: torch.Tensor) -> tuple[int | None, int, int, int]:
    """(P, M, K, N) of an [M, K] or [P, M, K] times [K, N] or [P, K, N]
    call (P None: no candidate axis); raises where the shapes do not chain."""
    if s.dim() not in (2, 3) or w_q.dim() not in (2, 3) or s.shape[-1] != w_q.shape[-2]:
        raise ValueError(f"spike_matmul: shapes {tuple(s.shape)} @ {tuple(w_q.shape)} do not chain")
    ps = {t.shape[0] for t in (s, w_q) if t.dim() == 3}
    if len(ps) > 1:
        raise ValueError(f"spike_matmul: candidate axes {tuple(s.shape)} and {tuple(w_q.shape)} differ")
    return (ps.pop() if ps else None), s.shape[-2], s.shape[-1], w_q.shape[-1]


def spike_matmul(
    s: torch.Tensor, w_q: torch.Tensor, counter: str = "spike_matmul.macs"
) -> torch.Tensor:
    """Exact int32 ``s @ w_q``: s int32 [M, K], w_q int32 [K, N] -> int32 [M, N].

    Either operand may carry a leading candidate axis of P (the other one is
    then shared by every candidate): the result is [P, M, N], all P products
    in one launch.  ``counter``: the device counter of
    :data:`~repro_torch.kernels.work.DEVICE_COUNTERS` that the call's
    multiply-adds by route go to, where a sink keeps it.
    """
    P, M, K, N = _operands(s, w_q)
    if s.device != w_q.device:
        raise ValueError(f"spike_matmul: operands on {s.device} and {w_q.device}")
    batch = 1 if P is None else P
    nbytes = 4 * (s.numel() + w_q.numel() + batch * M * N)
    call = work.kernel("spike_matmul", 2 * batch * M * K * N, nbytes, (s, w_q))
    if s.device.type == "cpu":
        with call:
            return spike_matmul_plain(s, w_q)
    if s.device.type != "cuda":
        raise ValueError(f"spike_matmul: no kernel for device {s.device}")
    if s.dtype != torch.int32 or w_q.dtype != torch.int32:
        raise ValueError(f"spike_matmul: needs int32 operands, got {s.dtype} and {w_q.dtype}")
    if not (s.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("spike_matmul: operands must be contiguous")
    p = plan(M, K, N, batch)
    if p.grid[1] > 65535:
        raise ValueError(f"spike_matmul: N={N} exceeds the kernel's grid")
    if batch > 65535:
        raise ValueError(f"spike_matmul: {batch} candidates exceed the kernel's grid (65535)")
    macs = work.device_counter(counter, s.device)
    with call:
        out = torch.empty(*(() if P is None else (P,)), M, N, dtype=torch.int32, device=s.device)
        launch = build.entry("spike_matmul", "spike_matmul_launch", 4, 9)
        with torch.cuda.device(s.device):
            stream = torch.cuda.current_stream(s.device).cuda_stream
            code = launch(
                s.data_ptr(), w_q.data_ptr(), out.data_ptr(),
                None if macs is None else macs.data_ptr(), M, K, N, p.bn, p.grid[0],
                int(p.kind == "tensor"), batch, int(s.dim() == 3), int(w_q.dim() == 3), stream,
            )
            build.check(code, "spike_matmul")
    spike_matmul.launches += 1
    return out


spike_matmul.launches = 0


def spike_integrate(spikes: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Window-level integration currents [T, B, N] = spikes [T, B, K] @ w_q (exact).

    Flattens the window to one [T*B, K] product; the kernel masks ragged
    edges, so unlike the JAX wrapper there is no shape-dependent fallback.
    """
    T, B, K = spikes.shape
    s2 = spikes.to(torch.int32).reshape(T * B, K).contiguous()
    out = spike_matmul(s2, w_q.to(torch.int32).contiguous())
    return out.reshape(T, B, -1)
