"""Plain PyTorch version of the quantized matmul (the numerics contract).

Contract: ``y = (x @ q_f32) * scale[None, :]`` computed in f32, cast to the
output dtype at the end.  Per-output-channel symmetric scales commute with
the contraction, so applying them after the accumulation is exact -- which
is what lets the kernel multiply raw integer weights and scale in the
epilogue.
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import unpack_int4

__all__ = ["quant_matmul_ref"]


def quant_matmul_ref(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bits: int, out_dtype: torch.dtype
) -> torch.Tensor:
    """x [..., K] x (q [K, N] or packed [K, N/2], scale [N]) -> [..., N] in ``out_dtype``."""
    w = unpack_int4(q) if bits == 4 else q
    acc = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return (acc * scale).to(out_dtype)
