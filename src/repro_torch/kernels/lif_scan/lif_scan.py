"""Fused fixed-point LIF/IF window scan: the ``lif_scan`` kernel.

Port of ``repro/kernels/lif_scan/lif_scan.py``; the CUDA source is
``csrc/lif_scan.cu`` (one thread per neuron, membrane in a register across
the T loop).  theta, the decay code, ``u_bits`` and the reset mode are
runtime arguments of the kernel.

For a CPU tensor the wrapper runs :func:`lif_scan_ref`; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.fixed_point import int_max, int_min
from repro_torch.kernels import build
from repro_torch.kernels.lif_scan.ref import lif_scan_ref

__all__ = ["lif_scan"]

_INT32_MIN, _INT32_MAX = int_min(32), int_max(32)


def lif_scan(
    currents: torch.Tensor,  # int32 [T, B, N]
    *,
    theta_q,
    decay_k: int,
    u_bits: int = 16,
    reset_to_zero: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused LIF window scan. Returns (spikes int32 [T, B, N], final_u int32 [B, N]).

    ``theta_q`` may be an int or an int32 scalar tensor; on the card a tensor
    is read once on the host (one sync per call).
    """
    if currents.dim() != 3:
        raise ValueError(f"lif_scan: currents must be [T, B, N], got {tuple(currents.shape)}")
    if not 0 <= decay_k <= 256:
        raise ValueError(f"lif_scan: decay_k must be in [0, 256], got {decay_k}")
    if not 2 <= u_bits <= 31:
        raise ValueError(f"lif_scan: u_bits must be in [2, 31], got {u_bits}")
    if currents.device.type == "cpu":
        return lif_scan_ref(currents, theta_q, decay_k, u_bits, reset_to_zero)
    if currents.device.type != "cuda":
        raise ValueError(f"lif_scan: no kernel for device {currents.device}")
    if currents.dtype != torch.int32 or not currents.is_contiguous():
        raise ValueError("lif_scan: currents must be contiguous int32")
    theta = int(theta_q)
    if not _INT32_MIN <= theta <= _INT32_MAX:
        raise ValueError(f"lif_scan: theta_q={theta} is outside int32")
    T, B, N = currents.shape
    spikes = torch.empty(T, B, N, dtype=torch.int32, device=currents.device)
    u_final = torch.empty(B, N, dtype=torch.int32, device=currents.device)
    launch = build.entry("lif_scan", "lif_scan_launch", 3, 7)
    with torch.cuda.device(currents.device):
        stream = torch.cuda.current_stream(currents.device).cuda_stream
        code = launch(
            currents.data_ptr(), spikes.data_ptr(), u_final.data_ptr(), T, B * N, theta,
            decay_k, int_min(u_bits), int_max(u_bits), int(reset_to_zero), stream,
        )
        build.check(code, "lif_scan")
    lif_scan.launches += 1
    return spikes, u_final


lif_scan.launches = 0
