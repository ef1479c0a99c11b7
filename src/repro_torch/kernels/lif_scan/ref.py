"""Plain PyTorch version of the fused LIF/IF time scan (the numerics contract).

Semantics are exactly ``int_layer_step`` iterated over a window, restricted
to the IF/LIF datapath: per step t,

    U   <- sat(U + I[t])                  (integration, u_bits register)
    spk <- U >= theta
    U   <- spk ? reset(U) : CG_decay(U)   (decay = gated sum of right shifts)

The ``lif_scan`` CUDA kernel must match it bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.fixed_point import saturate


def decay_shift_add(u: torch.Tensor, k: int) -> torch.Tensor:
    """CG: sum of arithmetic right shifts selected by bits of k (k/256)."""
    acc = torch.zeros_like(u)
    for shift in range(1, 9):
        if (k >> (8 - shift)) & 1:
            acc = acc + (u >> shift)
    return acc


def lif_scan_ref(
    currents: torch.Tensor,  # int32 [T, B, N] -- weighted input current per step
    theta_q,  # int or int32 scalar tensor
    decay_k: int,  # 0..255, or 256 for bypass (IF)
    u_bits: int = 16,
    reset_to_zero: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (spikes int32 [T, B, N], final_u int32 [B, N])."""
    T, B, N = currents.shape
    u = torch.zeros(B, N, dtype=torch.int32, device=currents.device)
    spikes = []
    for t in range(T):
        u = saturate(u + currents[t].to(torch.int32), u_bits)
        spk = (u >= theta_q).to(torch.int32)
        if reset_to_zero:
            u_reset = torch.zeros_like(u)
        else:
            u_reset = saturate(u - theta_q, u_bits)
        if decay_k >= 256:
            u_leak = u
        else:
            u_leak = saturate(decay_shift_add(u, decay_k), u_bits)
        u = torch.where(spk == 1, u_reset, u_leak)
        spikes.append(spk)
    if not spikes:
        return torch.zeros(0, B, N, dtype=torch.int32, device=currents.device), u
    return torch.stack(spikes), u
