"""Flash attention in the model's [B, S, H, D] layout, with grouped-query heads.

Unlike the JAX wrapper, nothing is transposed or repeated: the kernel takes
the [B, S, H, D] strides as they are and maps each query head to its kv
head itself.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention

__all__ = ["flash_attend"]


def flash_attend(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """GQA flash attention in model layout. Returns [B, Sq, Hq, D]."""
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap, scale=scale,
    )
    return out.transpose(1, 2)
