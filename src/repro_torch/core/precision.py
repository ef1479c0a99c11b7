"""LM-scale precision machinery: quantized tensors, policies, quantized matmul.

Port of ``repro/core/precision.py``.  Every large 2-D weight can be stored at
a reduced precision chosen per layer group, and the matmul executes against
the quantized representation.

Storage formats:

* bits = 8            -> int8, per-output-channel symmetric scale
* bits in {5, 6, 7}   -> value grid of 2^bits levels stored in int8
* bits = 4            -> two nibbles packed per int8 (true 2x byte saving)
* bits = 16 / None    -> plain float tensor (no quantization)

``qdot(x, w)`` contracts x's last axis with w's first.  On a :class:`QTensor`
it always goes through the ``quant_matmul`` wrapper: the plain version for
CPU tensors, the CUDA kernel for CUDA tensors.  Unlike the JAX package there
is no hook to enable; on the card the kernel is never optional.
"""

from __future__ import annotations

import dataclasses
import re

import torch

__all__ = [
    "QTensor",
    "pack_int4",
    "unpack_int4",
    "quantize_weight",
    "dequantize_weight",
    "qdot",
    "PrecisionPolicy",
    "quantize_tree",
    "tree_map",
]


@dataclasses.dataclass
class QTensor:
    """Symmetric per-output-channel quantized weight.

    2-D form: ``q`` int8 [K, N] (bits >= 5) or packed int8 [K, N//2] (bits = 4),
    ``scale`` f32 [N], ``shape`` (K, N).  Stacked form (one slice per layer
    group): ``q`` [L, K, ...], ``scale`` [L, N], ``shape`` (L, K, N);
    :meth:`layer` takes one slice.
    """

    q: torch.Tensor
    scale: torch.Tensor
    bits: int
    shape: tuple[int, ...]

    def layer(self, i: int) -> "QTensor":
        """Slice ``i`` of a stacked [L, K, N] QTensor (views, no copy)."""
        if len(self.shape) != 3:
            raise ValueError(f"layer() needs a stacked QTensor, got shape {self.shape}")
        return QTensor(q=self.q[i], scale=self.scale[i], bits=self.bits, shape=self.shape[1:])

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device), self.bits, self.shape)


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def pack_int4(values: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], last axis even -> packed int8 [..., N/2]."""
    lo = values[..., 0::2] & 0xF
    hi = values[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """packed int8 [..., N/2] -> int8 values [..., N] (sign-extended)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed.view(torch.uint8) >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def quantize_weight(w: torch.Tensor, bits: int) -> QTensor:
    """Quantize a [K, N] float weight to ``bits`` (per-column symmetric).

    f32 throughout: ``scale = absmax / qmax + 1e-12``, then round half to even
    and clip -- the same IEEE operations as the JAX package, so the result is
    bit-equal on the same f32 weights.
    """
    if w.dim() != 2:
        raise ValueError(f"quantize_weight expects 2-D weights, got {tuple(w.shape)}")
    if not 4 <= bits <= 8:
        raise ValueError(f"bits must be in [4, 8], got {bits}")
    wf = w.to(torch.float32)
    qmax = _qmax(bits)
    absmax = wf.abs().amax(dim=0)  # [N]
    scale = absmax / qmax + 1e-12
    q = torch.clamp(torch.round(wf / scale), -qmax - 1, qmax).to(torch.int8)
    if bits == 4:
        if w.shape[1] % 2:
            raise ValueError("int4 packing requires an even output dim")
        return QTensor(q=pack_int4(q), scale=scale, bits=4, shape=tuple(w.shape))
    return QTensor(q=q, scale=scale, bits=bits, shape=tuple(w.shape))


def dequantize_weight(t: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_int4(t.q) if t.bits == 4 else t.q
    return (q.to(torch.float32) * t.scale[..., None, :]).to(dtype)


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """Contract x's last axis with w's first; w may be a QTensor."""
    if isinstance(w, QTensor):
        # imported here: the wrapper's plain version imports this module
        from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul

        if len(w.shape) != 2:
            raise ValueError(f"qdot: needs a 2-D QTensor, got shape {w.shape}")
        K, N = w.shape
        out = quant_matmul(x.reshape(-1, K).contiguous(), w.q, w.scale, bits=w.bits)
        return out.reshape(*x.shape[:-1], N)
    return torch.matmul(x, w.to(x.dtype))


# --------------------------------------------------------------------------
# Policies over parameter trees
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Maps parameter paths (regex, first match wins) to bit-widths.

    ``{"mlp/.*": 4, "attn/.*": 8}`` quantizes MLP weights to 4 bits and
    attention projections to 8; unmatched leaves stay at full precision.
    """

    rules: tuple[tuple[str, int | None], ...] = ()

    def bits_for(self, path: str) -> int | None:
        for pattern, bits in self.rules:
            if re.search(pattern, path):
                return bits
        return None


def tree_map(fn, tree, path: str = ""):
    """Apply ``fn(path, leaf)`` to every leaf of a nested-dict parameter tree.

    ``path`` is the leaf's keys joined by ``/`` (the JAX package's path
    strings for dict trees); ``None`` leaves stay ``None``.
    """
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(path, tree)


def quantize_tree(params, policy: PrecisionPolicy):
    """Apply a policy to a parameter tree; 2-D and stacked [L, K, N] leaves only."""

    def visit(path, leaf):
        bits = policy.bits_for(path)
        if bits is None or bits >= 16 or not isinstance(leaf, torch.Tensor):
            return leaf
        if leaf.dim() == 2:
            return quantize_weight(leaf, bits)
        if leaf.dim() == 3:  # stacked layers: quantize each slice
            qts = [quantize_weight(leaf[i], bits) for i in range(leaf.shape[0])]
            return QTensor(
                q=torch.stack([t.q for t in qts]),
                scale=torch.stack([t.scale for t in qts]),
                bits=bits,
                shape=tuple(leaf.shape),
            )
        return leaf

    return tree_map(visit, params)
