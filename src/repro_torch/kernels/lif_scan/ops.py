"""Public entry point for the fused LIF window.

``fused_lif_window`` = integration product (spikes x quantized weights,
through ``spike_integrate``) followed by the membrane scan (``lif_scan``).
Both wrappers pick the CUDA kernel or the plain version by the tensors'
device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lif_scan.lif_scan import lif_scan
from repro_torch.kernels.quant_matmul.spike_matmul import spike_integrate

__all__ = ["fused_lif_window"]


def fused_lif_window(
    spikes_in: torch.Tensor,  # int [T, B, n_in] input spike raster
    w_q: torch.Tensor,  # int32 [n_in, N] quantized weights
    *,
    theta_q,
    decay_k: int,
    u_bits: int = 16,
    reset_to_zero: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integration + membrane scan for a full window. Returns (spikes, u)."""
    currents = spike_integrate(spikes_in, w_q)
    return lif_scan(
        currents, theta_q=theta_q, decay_k=decay_k, u_bits=u_bits, reset_to_zero=reset_to_zero
    )
