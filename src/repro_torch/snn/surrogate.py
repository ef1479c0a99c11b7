"""Surrogate-gradient spike nonlinearities for BPTT (port of
``repro/snn/surrogate.py``).

Forward: Heaviside on the membrane-minus-threshold argument, ``(x >= 0)``
as float32.  Backward: a smooth surrogate -- the fast-sigmoid derivative of
SNN-Torch's default (``1 / (slope*|x| + 1)^2``) or an arctan variant --
each a ``torch.autograd.Function`` with the JAX version's ``bwd`` formula.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fast_sigmoid", "atan_surrogate"]


class _FastSigmoidSpike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope: float):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return (x >= 0).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / (ctx.slope * torch.abs(x) + 1.0) ** 2, None


class _AtanSpike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha: float):
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return (x >= 0).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        a = ctx.alpha
        return g * a / (2.0 * (1.0 + (math.pi / 2.0 * a * x) ** 2)), None


def fast_sigmoid(slope: float = 25.0):
    """SNN-Torch's default surrogate."""
    return lambda x: _FastSigmoidSpike.apply(x, slope)


def atan_surrogate(alpha: float = 2.0):
    """ArcTan surrogate (Fang et al.); wider gradient support."""
    return lambda x: _AtanSpike.apply(x, alpha)
