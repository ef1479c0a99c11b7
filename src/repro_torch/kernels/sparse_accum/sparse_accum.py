"""Fixed-capacity sparse event accumulation: the ``sparse_accum`` kernel.

Port of ``repro/kernels/sparse_accum/sparse_accum.py``; the CUDA source is
``csrc/sparse_accum.cu``.  Computes ``out[e] = sum_j vals[e, j] *
w_q[idx[e, j]]`` in exact int32, skipping zero-valued (padding) slots
wherever they lie; the kernel runs a warp per event row, so E sets no grid
limit.

For a CPU tensor the wrapper runs :func:`sparse_accum_ref`; for a CUDA
tensor it launches the kernel or raises.  Each call reports its work through
:func:`~repro_torch.kernels.work.kernel` by its slot budget, not by the
events present (which only the card knows): a multiply-add per slot and
output column, each slot's value and index read, the [n_in, N] weight table
once and the [E, N] int32 output written.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.sparse_accum.ref import sparse_accum_ref

__all__ = ["sparse_accum"]


def sparse_accum(vals: torch.Tensor, idx: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``sum_j vals[e, j] * w_q[idx[e, j]]`` -> int32 [E, N]."""
    if vals.dim() != 2 or vals.shape != idx.shape or w_q.dim() != 2:
        raise ValueError(
            f"sparse_accum: vals {tuple(vals.shape)} / idx {tuple(idx.shape)} must be equal "
            f"[E, K] and w_q {tuple(w_q.shape)} [n_in, N]"
        )
    if not (vals.device == idx.device == w_q.device):
        raise ValueError("sparse_accum: operands on different devices")
    E, K = vals.shape
    n_in, N = w_q.shape
    nbytes = 4 * (2 * E * K + n_in * N + E * N)
    call = work.kernel("sparse_accum", 2 * E * K * N, nbytes, (vals, idx, w_q))
    if vals.device.type == "cpu":
        with call:
            return sparse_accum_ref(vals, idx, w_q)
    if vals.device.type != "cuda":
        raise ValueError(f"sparse_accum: no kernel for device {vals.device}")
    for name, t in (("vals", vals), ("idx", idx), ("w_q", w_q)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"sparse_accum: {name} must be contiguous int32")
    if n_in == 0 and K > 0:
        raise ValueError("sparse_accum: an empty weight table cannot take events")
    if n_in * N >= 2**32:
        raise ValueError(f"sparse_accum: a weight table of {n_in} x {N} exceeds 32-bit offsets")
    with call:
        out = torch.empty(E, N, dtype=torch.int32, device=vals.device)
        launch = build.entry("sparse_accum", "sparse_accum_launch", 4, 4)
        with torch.cuda.device(vals.device):
            stream = torch.cuda.current_stream(vals.device).cuda_stream
            code = launch(
                vals.data_ptr(), idx.data_ptr(), w_q.data_ptr(), out.data_ptr(), E, K, n_in, N,
                stream,
            )
            build.check(code, "sparse_accum")
    sparse_accum.launches += 1
    return out


sparse_accum.launches = 0
