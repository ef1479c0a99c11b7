"""Plain PyTorch version of the flash-attention kernel (the numerics contract).

Materialised attention in f32 with optional causal / sliding-window masks
and gemma2-style logit soft-capping; positions are 0..Sq-1 and 0..Sk-1.  The
kernel must match to ~1e-2 relative (bf16 inputs, f32 accumulation in both).
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention_ref"]

NEG_INF = -2.3819763e38


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = scale if scale is not None else D**-0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp - kp >= 0
    if window is not None:
        ok &= qp - kp < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32)).to(q.dtype)
