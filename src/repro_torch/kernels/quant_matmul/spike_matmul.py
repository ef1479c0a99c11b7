"""Exact int32 spike x quantized-weight product: the ``spike_matmul`` kernel.

Port of ``repro/kernels/quant_matmul/spike_matmul.py``.  On the card this
wrapper is the only exact int32 product of the port: PyTorch's CUDA matmul
has no int32 path and ``torch._int_mm`` takes int8 only, so phase A
(``int_phase_a``), the ATA_T recurrence, ``spike_integrate`` and the dense
fallbacks all come here.  The CUDA source is ``csrc/spike_matmul.cu``.

For a CPU tensor the wrapper runs :func:`spike_matmul_plain` (int32
``torch.matmul``, which wraps mod 2**32 like the JAX product); for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["spike_matmul", "spike_matmul_plain", "spike_integrate"]


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
    if (M + 63) // 64 > 65535:
        raise ValueError(f"spike_matmul: M={M} exceeds the kernel's grid")
    out = torch.empty(M, N, dtype=torch.int32, device=s.device)
    launch = build.entry("spike_matmul", "spike_matmul_launch", 3, 3)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        build.check(launch(s.data_ptr(), w_q.data_ptr(), out.data_ptr(), M, K, N, stream), "spike_matmul")
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
