"""Activation x int8/int4-weight matmul: the ``quant_matmul`` kernel.

Port of ``repro/kernels/quant_matmul/quant_matmul.py``; the CUDA source is
``csrc/quant_matmul.cu`` (64 x 64 output tiles, the K loop inside the block
with an f32 accumulator, the per-column scale in the epilogue).  The kernel
masks ragged M, N and K itself, so unlike the JAX wrapper there is no
shape-dependent fallback; int4 needs only an even N.

For CPU tensors the wrapper runs :func:`~.ref.quant_matmul_ref`; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

__all__ = ["quant_matmul"]

_DTYPES = (torch.bfloat16, torch.float32)


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
    if x.device.type == "cpu":
        return quant_matmul_ref(x, q, scale, bits, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"quant_matmul: the kernel takes bf16/f32, got {x.dtype} -> {out_dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"quant_matmul: needs int8 q and f32 scale, got {q.dtype}, {scale.dtype}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("quant_matmul: operands must be contiguous")
    if (M + 63) // 64 > 65535:
        raise ValueError(f"quant_matmul: M={M} exceeds the kernel's grid")
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    launch = build.entry("quant_matmul", "quant_matmul_launch", 4, 6)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, bits,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), stream,
        )
        build.check(code, "quant_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
