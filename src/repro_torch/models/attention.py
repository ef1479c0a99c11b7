"""Grouped-query attention with RoPE / M-RoPE, softcap and sliding windows.

Port of ``repro/models/attention.py``.  Shapes follow the
[batch, seq, heads, head_dim] convention throughout.

* :func:`attend` is the plain materialised attention (prefill below 4096
  tokens) and :func:`decode_attend` the one-token decode against a KV cache,
  including the int8-cache path; both are plain PyTorch, as the JAX package
  computes them outside any Pallas kernel.
* :func:`attend_chunked` (prefill at 4096 tokens and more) launches the
  ``flash_attention`` kernel for CUDA tensors; for CPU tensors it runs
  :func:`attend_query_chunked`, the JAX package's exact query-chunked plain
  code, which train mode runs on every device (the kernel has no backward).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention.ops import flash_attend

__all__ = [
    "rope",
    "mrope",
    "attend",
    "attend_chunked",
    "attend_query_chunked",
    "AttnMask",
    "decode_attend",
    "KVCache",
]

NEG_INF = -2.3819763e38  # matches the JAX package and the kernel


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions [...,] -> (sin, cos) of shape [..., dim/2]."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freq = 1.0 / (theta**exps)
    ang = positions.to(torch.float32)[..., None] * freq  # [..., dim/2]
    return torch.sin(ang), torch.cos(ang)


def _apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [..., H, dim]; sin/cos broadcastable to [..., 1, dim/2]."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Standard RoPE. x: [B, S, H, D]; positions: [B, S] or [S]."""
    sin, cos = _rope_angles(positions, x.shape[-1], theta)
    return _apply_rotary(x, sin[..., None, :], cos[..., None, :])


def mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float = 10_000.0, sections=(16, 24, 24)):
    """Multimodal RoPE (qwen2-vl). positions3: [3, B, S] (t, h, w); the dim/2
    frequency slots are split into ``sections``, each rotated by its own
    position component."""
    dim = x.shape[-1]
    if sum(sections) != dim // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to dim/2 = {dim // 2}")
    sin3, cos3 = _rope_angles(positions3, dim, theta)  # [3, B, S, dim/2], one pass for t, h, w
    bounds = (0, sections[0], sections[0] + sections[1], dim // 2)
    sin = torch.cat([sin3[i, ..., bounds[i] : bounds[i + 1]] for i in range(3)], dim=-1)
    cos = torch.cat([cos3[i, ..., bounds[i] : bounds[i + 1]] for i in range(3)], dim=-1)
    return _apply_rotary(x, sin[..., None, :], cos[..., None, :])


# --------------------------------------------------------------------------
# Masks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnMask:
    causal: bool = True
    window: int | None = None  # sliding window size (gemma2 local layers)

    def build(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        """q_pos [Sq], k_pos [Sk] -> bool [Sq, Sk] (True = attend)."""
        d = q_pos[:, None] - k_pos[None, :]
        ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
        if self.causal:
            ok &= d >= 0
        if self.window is not None:
            ok &= d < self.window
        return ok


# --------------------------------------------------------------------------
# Core attention
# --------------------------------------------------------------------------


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B,Sq,Hq,D], k [B,Sk,Hk,D] -> scores [B,Hk,G,Sq,Sk] (G = Hq/Hk), f32."""
    B, Sq, Hq, D = q.shape
    Hk = k.shape[2]
    if Hq % Hk:
        raise ValueError(f"GQA requires n_heads % n_kv == 0 ({Hq} % {Hk})")
    qg = q.reshape(B, Sq, Hk, Hq // Hk, D)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32), k.to(torch.float32)) * scale


def _softcap(scores: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def attend(
    q, k, v, *, mask: AttnMask = AttnMask(), q_positions=None, k_positions=None,
    softcap: float | None = None, scale: float | None = None, kv_valid_len=None,
):
    """Full (prefill) attention. Returns [B, Sq, Hq, D].

    ``kv_valid_len`` masks cache tail entries ([B] int).
    """
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else D**-0.5
    scores = _softcap(_gqa_scores(q, k, scale), softcap)  # [B,Hk,G,Sq,Sk] f32
    dev = q.device
    q_pos = q_positions if q_positions is not None else torch.arange(Sq, device=dev)
    k_pos = k_positions if k_positions is not None else torch.arange(Sk, device=dev)
    m = mask.build(q_pos, k_pos)  # [Sq, Sk]
    scores = torch.where(m[None, None, None], scores, NEG_INF)
    if kv_valid_len is not None:
        valid = torch.arange(Sk, device=dev)[None] < kv_valid_len[:, None]  # [B, Sk]
        scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _is_arange(pos, n: int) -> bool:
    return pos is None or (
        pos.dim() == 1 and torch.equal(pos, torch.arange(n, device=pos.device, dtype=pos.dtype))
    )


def attend_chunked(
    q, k, v, *, mask: AttnMask = AttnMask(), q_positions=None, k_positions=None,
    softcap: float | None = None, scale: float | None = None, q_chunk: int = 1024,
):
    """Exact attention without the full [Sq, Sk] score matrix. Returns [B, Sq, Hq, D].

    CUDA tensors: the ``flash_attention`` kernel, which takes positions
    0..Sq-1 and 0..Sk-1 only; other positions raise.  ``meta`` tensors (a
    dry run) take the kernel's route as CUDA tensors do; their positions
    hold no values to check.  CPU tensors: :func:`attend_query_chunked`.
    """
    if q.device.type in ("cuda", "meta"):
        if q.device.type == "cuda" and not (
            _is_arange(q_positions, q.shape[1]) and _is_arange(k_positions, k.shape[1])
        ):
            raise ValueError(
                "attend_chunked: the flash_attention kernel takes positions 0..S-1 only"
            )
        return flash_attend(
            q, k, v, causal=mask.causal, window=mask.window, softcap=softcap, scale=scale
        )
    return attend_query_chunked(
        q, k, v, mask=mask, q_positions=q_positions, k_positions=k_positions,
        softcap=softcap, scale=scale, q_chunk=q_chunk,
    )


def attend_query_chunked(
    q, k, v, *, mask: AttnMask = AttnMask(), q_positions=None, k_positions=None,
    softcap: float | None = None, scale: float | None = None, q_chunk: int = 1024,
):
    """The JAX package's ``attend_chunked``: plain attention over ``q_chunk``
    queries at a time (softmax is row-wise over keys, so chunking queries is
    exact), on any device and differentiable.  Returns [B, Sq, Hq, D]."""
    Sq = q.shape[1]
    if Sq % q_chunk:
        return attend(
            q, k, v, mask=mask, q_positions=q_positions, k_positions=k_positions,
            softcap=softcap, scale=scale,
        )
    q_pos = q_positions if q_positions is not None else torch.arange(Sq, device=q.device)
    k_pos = k_positions if k_positions is not None else torch.arange(k.shape[1], device=q.device)
    outs = [
        attend(
            q[:, i : i + q_chunk], k, v, mask=mask, q_positions=q_pos[i : i + q_chunk],
            k_positions=k_pos, softcap=softcap, scale=scale,
        )
        for i in range(0, Sq, q_chunk)
    ]
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# KV cache + decode
# --------------------------------------------------------------------------


class KVCache:
    """Helpers over a {'k': [B,S,Hk,D], 'v': ..., 'len': [B]} dict."""

    @staticmethod
    def template(batch: int, max_len: int, n_kv: int, d_head: int, dtype=torch.bfloat16):
        """{name: (shape, dtype)} of one layer's cache."""
        return {
            "k": ((batch, max_len, n_kv, d_head), dtype),
            "v": ((batch, max_len, n_kv, d_head), dtype),
            "len": ((batch,), torch.int32),
        }

    @staticmethod
    def append_one(cache, k_new, v_new):
        """Insert one token's K/V at each sample's current length.

        Updates ``cache`` in place (the JAX version returns a new dict): the
        serving engine's caches are preallocated and written where they lie.
        As with ``dynamic_update_slice``, the write position is clamped to the
        last slot while ``len`` keeps counting.
        """
        idx = cache["len"].clamp(max=cache["k"].shape[1] - 1).long()  # [B]
        rows = torch.arange(idx.shape[0], device=idx.device)
        cache["k"][rows, idx] = k_new[:, 0]
        cache["v"][rows, idx] = v_new[:, 0]
        cache["len"] += 1
        return cache


def decode_attend(
    q, cache, *, softcap=None, scale=None, window: int | None = None,
    kv_inv_scale: float | None = None,
):
    """One-token decode attention against a KV cache.

    q: [B, 1, Hq, D]; cache K/V: [B, S, Hk, D] with 'len' valid entries.  A
    sliding window additionally masks entries older than ``window``.
    ``kv_inv_scale`` dequantizes an int8 cache: scores and outputs are linear
    in K/V, so it folds into one scalar multiply each.
    """
    Sk = cache["k"].shape[1]
    kv_len = cache["len"]
    k_pos = torch.arange(Sk, device=q.device)
    valid = k_pos[None] < kv_len[:, None]
    if window is not None:
        valid &= k_pos[None] >= (kv_len[:, None] - window)
    D = q.shape[-1]
    scale = scale if scale is not None else D**-0.5
    scores = _gqa_scores(q, cache["k"], scale)  # [B,Hk,G,1,S]
    if kv_inv_scale is not None:
        scores = scores * kv_inv_scale
    scores = _softcap(scores, softcap)
    scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cache["v"].to(torch.float32))
    if kv_inv_scale is not None:
        out = out * kv_inv_scale
    B, _, Hq, _ = q.shape
    return out.reshape(B, 1, Hq, D).to(q.dtype)
