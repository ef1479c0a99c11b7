"""Activation x int8/int4-weight matmul: the ``quant_matmul`` kernel.

Port of ``repro/kernels/quant_matmul/quant_matmul.py``; the CUDA source is
``csrc/quant_matmul.cu``.  bf16 activations run on the tensor cores in one
of two configurations that :func:`plan` picks from the shape alone: *skinny*
(M <= 64, decode: ``mma.sync`` on 16 x 64 tiles, K split over blocks, the
partial sums added in a fixed order) and *wide* (M > 64, prefill: ``wgmma``
on 128 x 128 tiles, the whole K loop in the block, so a row's result does
not depend on M; the tensor cores' f32 chain is promoted into f32 sums
every 512 K).  f32 activations keep the first version's CUDA-core
kernel.  The kernel masks ragged M, N and K itself, so unlike the JAX
wrapper there is no shape-dependent fallback; int4 needs only an even N.

For CPU tensors the wrapper runs :func:`~.ref.quant_matmul_ref`; for CUDA
tensors it launches the kernel or raises; for ``meta`` tensors (a dry run)
it validates the call as for CUDA and returns the output's allocation.
Each call reports its 2 M K N operations and its bytes through
:func:`~repro_torch.kernels.work.kernel`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

__all__ = ["QMPlan", "plan", "quant_matmul"]

_DTYPES = (torch.bfloat16, torch.float32)

# The tiles of csrc/quant_matmul.cu, and the card's SM count (H100 SXM)
SKINNY_MAX_M = 64
SKINNY_BM, SKINNY_BN, SKINNY_BK = 16, 64, 64
WIDE_BM, WIDE_BN = 128, 128
SIMT_BM, SIMT_BN = 64, 64
N_SMS = 132
KINDS = {"simt": 0, "skinny": 1, "wide": 2}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class QMPlan:
    """How one call runs: ``kind`` ("simt", "skinny" or "wide"), the blocks
    along K (``splits``), the CUDA grid, and the f32 workspace elements
    (``splits * M * N`` when K is split, else 0)."""

    kind: str
    splits: int
    grid: tuple[int, int, int]
    workspace: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def plan(M: int, K: int, N: int, x_bf16: bool = True) -> QMPlan:
    """The configuration for an [M, K] x [K, N] call; a function of the shape
    (and of x's dtype) only.  Skinny calls split K into the fewest power-of-two
    parts (then as few equal chunks of 64-deep stages) that give at least two
    blocks per SM; the split depends on K and N, never on M."""
    if not x_bf16:
        return QMPlan("simt", 1, (_cdiv(N, SIMT_BN), _cdiv(M, SIMT_BM), 1), 0)
    if M > SKINNY_MAX_M:
        return QMPlan("wide", 1, (_cdiv(N, WIDE_BN), _cdiv(M, WIDE_BM), 1), 0)
    col_blocks, n_stages = _cdiv(N, SKINNY_BN), _cdiv(K, SKINNY_BK)
    splits = 1
    while col_blocks * splits < 2 * N_SMS and splits < n_stages:
        splits *= 2
    if splits > 1:
        splits = _cdiv(n_stages, _cdiv(n_stages, splits))  # no empty split
    grid = (col_blocks, splits, _cdiv(M, SKINNY_BM))
    return QMPlan("skinny", splits, grid, splits * M * N if splits > 1 else 0)


# split-K arrival counters, one per skinny output tile; zero between calls
# (the last block of a tile resets its counter)
_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = _COUNTERS[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return c


def quant_matmul(
    x: torch.Tensor,  # [M, K] bf16/f32
    q: torch.Tensor,  # int8 [K, N] (bits >= 5) or packed int8 [K, N//2] (bits = 4)
    scale: torch.Tensor,  # f32 [N]
    *,
    bits: int = 8,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``(x_f32 @ q_f32) * scale`` accumulated in f32 -> [M, N] in ``out_dtype`` (default x's)."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError(
            f"quant_matmul: needs x [M, K], q 2-D, scale [N]; got {tuple(x.shape)}, "
            f"{tuple(q.shape)}, {tuple(scale.shape)}"
        )
    if not 4 <= bits <= 8:
        raise ValueError(f"quant_matmul: bits must be in [4, 8], got {bits}")
    M, K = x.shape
    N = scale.shape[0]
    want_q = (K, N // 2) if bits == 4 else (K, N)
    if tuple(q.shape) != want_q or (bits == 4 and N % 2):
        raise ValueError(f"quant_matmul: q {tuple(q.shape)} does not fit x {tuple(x.shape)}, N={N}")
    if not (x.device == q.device == scale.device):
        raise ValueError(f"quant_matmul: operands on {x.device}, {q.device}, {scale.device}")
    nbytes = x.numel() * x.element_size() + q.numel() + 4 * N + M * N * out_dtype.itemsize
    call = work.kernel("quant_matmul", 2 * M * K * N, nbytes, (x, q, scale))
    if x.device.type == "cpu":
        with call:
            return quant_matmul_ref(x, q, scale, bits, out_dtype)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"quant_matmul: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"quant_matmul: the kernel takes bf16/f32, got {x.dtype} -> {out_dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"quant_matmul: needs int8 q and f32 scale, got {q.dtype}, {scale.dtype}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("quant_matmul: operands must be contiguous")
    p = plan(M, K, N, x.dtype == torch.bfloat16)
    if max(p.grid[1:]) > 65535:
        raise ValueError(f"quant_matmul: M={M} exceeds the kernel's grid")
    with call:
        out = torch.empty(M, N, dtype=out_dtype, device=x.device)
        partial = torch.empty(p.workspace, dtype=torch.float32, device=x.device) if p.splits > 1 else None
        if x.device.type == "meta":  # a dry run: the call's allocations and work, no launch
            return out
        if partial is not None:
            counters = _counters(x.device, p.grid[0] * p.grid[2])
            extra = (partial.data_ptr(), counters.data_ptr())
        else:
            extra = (None, None)
        launch = build.entry("quant_matmul", "quant_matmul_launch", 6, 8)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = launch(
                x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), *extra, M, K, N, bits,
                int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), KINDS[p.kind],
                p.splits, stream,
            )
            build.check(code, "quant_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
