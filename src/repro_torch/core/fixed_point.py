"""Fixed-point arithmetic contracts shared by the bit-exact simulator and kernels.

Every on-chip quantity is a signed fixed-point integer whose bit-width is a
design-time parameter (``w_bits`` / ``w_rec_bits`` weights, ``u_bits``
membrane, ``i_bits`` synaptic current).  All integer arithmetic is int32 with
explicit saturation to the declared register width; int32 addition and
multiplication wrap mod 2**32 exactly as in the JAX package.

``exact_f32_matmul`` is the one float product on the integer datapath: it is
bit-exact only while every partial sum is an integer below 2**24 *and* the
product really runs in float32, so it refuses to run when TF32 is enabled.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "QuantSpec",
    "make_spec_from_absmax",
    "quantize_symmetric",
    "dequantize",
    "int_min",
    "int_max",
    "saturate",
    "sat_add",
    "arithmetic_rshift",
    "exact_f32_matmul",
]


def int_min(bits: int) -> int:
    """Smallest representable signed integer at ``bits`` width."""
    return -(1 << (bits - 1))


def int_max(bits: int) -> int:
    """Largest representable signed integer at ``bits`` width."""
    return (1 << (bits - 1)) - 1


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Symmetric signed fixed-point quantization spec.

    ``scale`` maps float -> integer: ``q = clip(round(x * scale))``; the same
    scale rescales thresholds and resets, so the integer dynamics mirror the
    float ones.
    """

    bits: int
    scale: float

    @property
    def qmin(self) -> int:
        return int_min(self.bits)

    @property
    def qmax(self) -> int:
        return int_max(self.bits)

    def quantize(self, x) -> torch.Tensor:
        return quantize_symmetric(x, self.bits, self.scale)

    def dequantize(self, q) -> torch.Tensor:
        return dequantize(q, self.scale)


def make_spec_from_absmax(x, bits: int, margin: float = 1.0) -> QuantSpec:
    """Build a QuantSpec so that ``margin * max|x|`` maps to the integer max."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    absmax = float(np.max(np.abs(a))) if a.size else 1.0
    absmax = max(absmax * margin, 1e-12)
    return QuantSpec(bits=bits, scale=int_max(bits) / absmax)


def quantize_symmetric(x, bits: int, scale: float) -> torch.Tensor:
    """Round-to-nearest-even symmetric quantization with clipping."""
    q = torch.round(torch.as_tensor(x, dtype=torch.float32) * scale)
    return torch.clamp(q, int_min(bits), int_max(bits)).to(torch.int32)


def dequantize(q, scale: float) -> torch.Tensor:
    return torch.as_tensor(q).to(torch.float32) / scale


def saturate(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Clamp an int32 value into the signed ``bits``-wide register range."""
    return torch.clamp(x, int_min(bits), int_max(bits))


def sat_add(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Saturating signed add: models the hardware accumulator at ``bits`` width."""
    return saturate(a + b, bits)


def arithmetic_rshift(x, n: int) -> torch.Tensor:
    """Arithmetic shift right on int32 (floor division by 2**n), as in RTL.

    torch's ``>>`` on signed integers sign-extends (``-7 >> 1 == -4``), like
    jnp's.
    """
    return torch.as_tensor(x, dtype=torch.int32) >> n


def exact_f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int32 ``x @ w`` through the float32 GEMM, for callers that certify it.

    The caller guarantees every partial sum is an integer of magnitude below
    2**24 (f32's exact-integer range), so products, sums in any order and the
    cast back to int32 are all exact.  TF32 would keep only 10 mantissa bits,
    so this raises unless float32 products run at full precision.
    """
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the certified f32 lowering is exact only without TF32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')"
        )
    return torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(torch.int32)
