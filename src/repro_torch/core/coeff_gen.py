"""Coefficient Generator (CG): multiplier-free leak, bit-exact (paper section 4.1.2).

The RTL realises ``x * k/256`` (k integer in [0, 255], or bypass for k = 256,
i.e. the IF model's "no leak") as a gated sum of arithmetic right shifts:

    DecayRate[8]   -> bypass (pass x through unchanged)
    DecayRate[7]   -> x >> 1   (1/2)
    ...
    DecayRate[0]   -> x >> 8   (1/256)

The shifts are arithmetic (sign-extending; floor semantics for negative
operands).  ``leak_bits`` (1..8) restricts k to multiples of
``2**(8 - leak_bits)``; in the RTL, ``SelectionUnits[3:0]`` gates the four
two-tap data blocks, and :func:`selection_units` returns that mask.  This
module is the port's single source of truth for decay numerics; the
``lif_scan`` CUDA kernel repeats the same shift set.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.fixed_point import arithmetic_rshift

__all__ = [
    "DecayCode",
    "encode_decay",
    "decode_factor",
    "apply_decay",
    "apply_decay_traced",
    "apply_decay_float",
    "selection_units",
    "max_value_error_bound",
    "quantization_grid",
]


@dataclasses.dataclass(frozen=True)
class DecayCode:
    """9-bit DecayRate register contents plus its design-time tap budget."""

    k: int  # DecayRate[7:0]; realised factor is k/256
    bypass: bool  # DecayRate[8]; True => factor 1.0 (IF model)
    leak_bits: int  # number of synthesised shift taps (1..8)

    @property
    def decay_rate_register(self) -> int:
        """The packed 9-bit register value DecayRate[8:0]."""
        return (int(self.bypass) << 8) | self.k

    @property
    def factor(self) -> float:
        return 1.0 if self.bypass else self.k / 256.0


def selection_units(leak_bits: int) -> int:
    """SelectionUnits[3:0]: which two-tap blocks ((1,2),(3,4),(5,6),(7,8)) exist."""
    if not 0 <= leak_bits <= 8:
        raise ValueError(f"leak_bits must be in [0, 8], got {leak_bits}")
    n_blocks = (leak_bits + 1) // 2
    return (1 << n_blocks) - 1


def encode_decay(beta: float, leak_bits: int = 8) -> DecayCode:
    """Round a float decay factor onto the CG's representable grid.

    With ``leak_bits`` taps the representable factors are multiples of
    ``2**(8 - leak_bits) / 256``; beta == 1.0 maps to the bypass path.
    """
    if not 0.0 <= beta <= 1.0:
        raise ValueError(f"decay factor must be in [0, 1], got {beta}")
    if not 1 <= leak_bits <= 8:
        raise ValueError(f"leak_bits must be in [1, 8], got {leak_bits}")
    step = 1 << (8 - leak_bits)
    k = int(round(beta * 256.0 / step)) * step
    if k >= 256:
        # beta rounds to 1.0: representable exactly via the bypass path.
        return DecayCode(k=0, bypass=True, leak_bits=leak_bits)
    return DecayCode(k=k, bypass=False, leak_bits=leak_bits)


def decode_factor(code: DecayCode) -> float:
    return code.factor


def apply_decay(x, code: DecayCode) -> torch.Tensor:
    """Bit-exact CG output for int32 input ``x``: the gated shift-add tree."""
    x = torch.as_tensor(x, dtype=torch.int32)
    if code.bypass:
        return x
    acc = torch.zeros_like(x)
    for shift in range(1, 9):
        if (code.k >> (8 - shift)) & 1:
            acc = acc + arithmetic_rshift(x, shift)
    return acc


def apply_decay_traced(x, decay_register) -> torch.Tensor:
    """Bit-exact CG output with the packed 9-bit DecayRate register as a value.

    Identical arithmetic to :func:`apply_decay`, but every shift tap is
    computed and gated arithmetically, so the register may be a tensor
    (bit 8 = bypass, bits 7..0 = k), as the population sweep passes it.
    """
    x = torch.as_tensor(x, dtype=torch.int32)
    k = torch.as_tensor(decay_register, dtype=torch.int32, device=x.device)
    acc = torch.zeros_like(x)
    for shift in range(1, 9):
        gate = (k >> (8 - shift)) & 1
        acc = acc + gate * arithmetic_rshift(x, shift)
    return torch.where(k >= 256, x, acc)


def apply_decay_float(x, code: DecayCode) -> torch.Tensor:
    """Float reference of the *factor* (not of the floor-shift arithmetic)."""
    return torch.as_tensor(x, dtype=torch.float32) * code.factor


def max_value_error_bound(code: DecayCode) -> float:
    """Upper bound on |apply_decay(x) - x*k/256| from floor-shift truncation.

    Each selected tap truncates < 1 LSB, so the bound is the tap count.
    """
    if code.bypass:
        return 0.0
    return float(bin(code.k).count("1"))


def quantization_grid(leak_bits: int) -> np.ndarray:
    """All representable decay factors at the given tap budget (plus bypass)."""
    step = 1 << (8 - leak_bits)
    return np.concatenate([np.arange(0, 256, step) / 256.0, [1.0]])
