"""Plain PyTorch version of the fused LIF/IF time scan (the numerics contract).

Semantics are exactly ``int_layer_step`` iterated over a window, restricted
to the IF/LIF datapath: per step t,

    U   <- sat(U + I[t])                  (integration, u_bits register)
    spk <- U >= theta
    U   <- spk ? reset(U) : CG_decay(U)   (decay = gated sum of right shifts)

With a candidate axis (the population sweep) the window is [P, T, B, N] and
theta and the 9-bit decay register are int32 [P], one per candidate; the
leak then gates every tap arithmetically, as ``apply_decay_traced`` does.
The ``lif_scan`` CUDA kernel must match it bit for bit.

:func:`ataf_scan_ref` is the same scan for an ATA-F (self-feedback) layer of
the population sweep, the plain version of the ``ataf_scan`` kernel: each
step first adds the neuron's previous spike times the candidate's
self-weight to I[t], as ``_integrate_acc`` does (int32, wrapping).
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


def _gated_shift_add(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """:func:`decay_shift_add` with ``k`` a tensor broadcast against ``u``."""
    acc = torch.zeros_like(u)
    for shift in range(1, 9):
        acc = acc + ((k >> (8 - shift)) & 1) * (u >> shift)
    return acc


def lif_scan_ref(
    currents: torch.Tensor,  # int32 [T, B, N], or [P, T, B, N] with a candidate axis
    theta_q,  # int or int32 scalar tensor; int32 [P] with a candidate axis
    decay_k,  # 0..255, or 256 for bypass (IF); the int32 [P] registers with a candidate axis
    u_bits: int = 16,
    reset_to_zero: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (spikes int32 [..., T, B, N], final_u int32 [..., B, N])."""
    return _scan(currents, theta_q, decay_k, u_bits, reset_to_zero)


def ataf_scan_ref(
    currents: torch.Tensor,  # int32 [P, T, B, N]
    w_self: torch.Tensor,  # int32 [P], each candidate's self-weight register
    theta_q: torch.Tensor,  # int32 [P]
    decay_k: torch.Tensor,  # int32 [P], the 9-bit decay registers (256 and above: bypass)
    u_bits: int = 16,
    reset_to_zero: bool = False,
) -> torch.Tensor:
    """Spikes int32 [P, T, B, N] of P ATA-F IF/LIF windows from zero state."""
    return _scan(currents, theta_q, decay_k, u_bits, reset_to_zero, w_self)[0]


def _scan(currents, theta_q, decay_k, u_bits, reset_to_zero, w_self=None):
    """The scan of :func:`lif_scan_ref`, with the previous spikes times
    ``w_self`` (int32 [P]) added to each step's current where it is given."""
    *lead, T, B, N = currents.shape
    dev = currents.device
    if lead:
        theta_q = torch.as_tensor(theta_q, dtype=torch.int32, device=dev).reshape(-1, 1, 1)
        k = torch.as_tensor(decay_k, dtype=torch.int32, device=dev).reshape(-1, 1, 1)
        leak = lambda u: torch.where(k >= 256, u, saturate(_gated_shift_add(u, k), u_bits))
    elif decay_k >= 256:
        leak = lambda u: u
    else:
        leak = lambda u: saturate(decay_shift_add(u, decay_k), u_bits)
    u = torch.zeros(*lead, B, N, dtype=torch.int32, device=dev)
    spikes = []
    for t in range(T):
        i_t = currents[..., t, :, :].to(torch.int32)
        if w_self is not None and spikes:
            i_t = i_t + spikes[-1] * w_self.reshape(-1, 1, 1)
        u = saturate(u + i_t, u_bits)
        spk = (u >= theta_q).to(torch.int32)
        if reset_to_zero:
            u_reset = torch.zeros_like(u)
        else:
            u_reset = saturate(u - theta_q, u_bits)
        u = torch.where(spk == 1, u_reset, leak(u))
        spikes.append(spk)
    if not spikes:
        return torch.zeros(*lead, 0, B, N, dtype=torch.int32, device=dev), u
    return torch.stack(spikes, dim=len(lead)), u

