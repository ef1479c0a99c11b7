"""Exact int32 spike x quantized-weight product: the ``spike_matmul`` kernel.

Port of ``repro/kernels/quant_matmul/spike_matmul.py``.  On the card this
wrapper is the only exact int32 product of the port: PyTorch's CUDA matmul
has no int32 path and ``torch._int_mm`` takes int8 only, so phase A
(``int_phase_a``), the ATA_T recurrence, ``spike_integrate`` and the dense
fallbacks all come here.  The CUDA source is ``csrc/spike_matmul.cu``.

The kernel runs on the int8 tensor cores wherever the block's weights fit
int8 (weights of at most 8 bits): a 16-row strip's 256-deep K chunk in one
pass when its spikes fit int8 (binary spikes), else in up to four byte-plane
passes -- exact for any int32 spikes.  Weights beyond int8 run on the CUDA
cores.  The routes are decided on the device; :func:`plan` picks the
block's columns, the number of persistent blocks and the shared memory from
the shape alone.

For a CPU tensor the wrapper runs :func:`spike_matmul_plain` (int32
``torch.matmul``, which wraps mod 2**32 like the JAX product); for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build

__all__ = ["SMPlan", "plan", "spike_matmul", "spike_matmul_plain", "spike_integrate"]

# The tiles of csrc/spike_matmul.cu, and the card's SM count (H100 SXM)
STRIP = 16  # rows of s a warp takes at a time (the mma's M)
CHUNK = 256  # K of one int8 chunk
WARPS = 8  # warps per block
MAX_BN = 128  # output columns per block
ROW_PAD = 16  # bytes after each int8 weight column in shared memory
SMEM_CAP = 227 * 1024  # shared memory a block may take (one block an SM)
N_SMS = 132


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


def plan(M: int, K: int, N: int) -> SMPlan:
    """The configuration for an [M, K] x [K, N] call; a function of the shape
    only.  A block covers N rounded up to a power of two, at most 128
    columns, halved while its shared memory (:func:`block_smem`) exceeds the
    budget; where even 8 columns do not fit, the call runs on the CUDA cores.
    One block an SM, each taking a contiguous range of 16-row strips, so M
    sets no grid limit."""
    bn = 8
    while bn < min(N, MAX_BN):
        bn *= 2
    while bn > 8 and block_smem(K, bn) > SMEM_CAP:
        bn //= 2
    kind = "tensor" if block_smem(K, bn) <= SMEM_CAP else "simt"
    if kind == "simt":
        bn = MAX_BN
    col_tiles = max(1, _cdiv(N, bn))
    blocks = max(1, min(_cdiv(M, STRIP), _cdiv(N_SMS, col_tiles)))
    smem = block_smem(K, bn) if kind == "tensor" else 0
    return SMPlan(kind, bn, (blocks, col_tiles), smem)


def spike_matmul_plain(s: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``s @ w_q`` in int32 with mod-2**32 wraparound.

    CPU: int32 ``torch.matmul``.  CUDA has no integer GEMM, so there the
    same sum is taken as K rank-1 updates in int32 (used only to check the
    kernel on the card).
    """
    if s.device.type != "cuda":
        return torch.matmul(s.to(torch.int32), w_q.to(torch.int32))
    out = torch.zeros(s.shape[0], w_q.shape[1], dtype=torch.int32, device=s.device)
    for k in range(s.shape[1]):
        out += s[:, k, None] * w_q[k]
    return out


def spike_matmul(s: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``s @ w_q``: s int32 [M, K], w_q int32 [K, N] -> int32 [M, N]."""
    if s.dim() != 2 or w_q.dim() != 2 or s.shape[1] != w_q.shape[0]:
        raise ValueError(f"spike_matmul: shapes {tuple(s.shape)} @ {tuple(w_q.shape)} do not chain")
    if s.device != w_q.device:
        raise ValueError(f"spike_matmul: operands on {s.device} and {w_q.device}")
    if s.device.type == "cpu":
        return spike_matmul_plain(s, w_q)
    if s.device.type != "cuda":
        raise ValueError(f"spike_matmul: no kernel for device {s.device}")
    if s.dtype != torch.int32 or w_q.dtype != torch.int32:
        raise ValueError(f"spike_matmul: needs int32 operands, got {s.dtype} and {w_q.dtype}")
    if not (s.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("spike_matmul: operands must be contiguous")
    M, K = s.shape
    N = w_q.shape[1]
    p = plan(M, K, N)
    if p.grid[1] > 65535:
        raise ValueError(f"spike_matmul: N={N} exceeds the kernel's grid")
    out = torch.empty(M, N, dtype=torch.int32, device=s.device)
    launch = build.entry("spike_matmul", "spike_matmul_launch", 3, 6)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        code = launch(
            s.data_ptr(), w_q.data_ptr(), out.data_ptr(), M, K, N, p.bn, p.grid[0],
            int(p.kind == "tensor"), stream,
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
