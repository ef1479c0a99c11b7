"""Online-softmax attention: the ``flash_attention`` kernel.

Port of ``repro/kernels/flash_attention/flash_attention.py``; the CUDA
source is ``csrc/flash_attention.cu`` (one block per (batch, head, 64-query
tile), the K/V loop inside the block, running max / sum / accumulator in
registers; bf16 on the tensor cores with P split into bf16 hi + lo for the
P V product, f32 on the CUDA cores).  Causal, sliding-window and soft-cap
masks; ragged Sq / Sk; grouped-query attention by reading kv head
``h // (Hq // Hk)`` directly.

For CPU tensors the wrapper runs :func:`~.ref.flash_attention_ref` (with the
kv heads repeated); for CUDA tensors it launches the kernel or raises; for
``meta`` tensors (a dry run) it validates the call as for CUDA and returns
the output's allocation, never the plain version's [B, H, Sq, Sk] scores.
Each call reports 4 B Hq D times the (query, key) pairs its masks keep
(:func:`~repro_torch.kernels.work.flash_pairs`) through
:func:`~repro_torch.kernels.work.kernel`.  The
kernel is forward-only (the JAX package has no flash backward either), so
an input that requires grad raises on every device rather than being
detached: training runs the plain attention
(``models/attention.py::attend_query_chunked``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention"]

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_D = 128


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hk, Sk, D], Hq % Hk == 0
    v: torch.Tensor,  # [B, Hk, Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention over positions 0..Sq-1 (queries) and 0..Sk-1 (keys) -> [B, Hq, Sq, D] in q's dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the kernel has no backward and an input requires grad; "
            "train through models.attention.attend_query_chunked"
        )
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hk:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    scale = scale if scale is not None else D**-0.5
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: operands on {q.device}, {k.device}, {v.device}")
    flops = 4 * B * Hq * D * work.flash_pairs(Sq, Sk, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    call = work.kernel("flash_attention", flops, nbytes, (q, k, v))
    if q.device.type == "cpu":
        rep = Hq // Hk
        with call:
            return flash_attention_ref(
                q, k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1),
                causal=causal, window=window, softcap=softcap, scale=scale,
            )
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: needs one bf16/f32 dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"flash_attention: the kernel takes 1 <= D <= {_MAX_D}, got {D}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if max(t.numel() for t in (q, k, v)) >= 2**31 or max(B * Hq, -(-Sq // 64)) > 65535:
        raise ValueError("flash_attention: tensors exceed the kernel's 32-bit indexing or grid")
    with call:
        out = torch.empty_like(q)  # keeps q's strides, so [B, S, H, D] views stay that layout
        if q.device.type == "meta":  # a dry run: the call's allocation and work, no launch
            return out
        launch = build.entry("flash_attention", "flash_attention_launch", 4, 21, 2)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Hq, Hk, Sq, Sk, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                int(causal), int(window or 0), int(q.dtype == torch.bfloat16),
                float(scale), float(softcap or 0.0), stream,
            )
            build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
