"""Fused fixed-point LIF/IF window scan: the ``lif_scan`` kernel.

Port of ``repro/kernels/lif_scan/lif_scan.py``; the CUDA source is
``csrc/lif_scan.cu`` (one thread per neuron, membrane in a register across
the T loop).  theta, the decay code, ``u_bits`` and the reset mode are
runtime arguments of the kernel, which reads theta and the decay register on
the device: with a candidate axis (currents [P, T, B, N], the population
sweep) they are int32 [P] tensors, one per candidate, and a single window
[T, B, N] launches as the case P = 1.

For a CPU tensor the wrapper runs :func:`lif_scan_ref`; for a CUDA tensor it
launches the kernel or raises.  Each call reports its work through
:func:`~repro_torch.kernels.work.kernel` (:func:`_call`).

:func:`ataf_scan` runs the population sweep's ATA-F (self-feedback) IF/LIF
windows the same way, one launch for every candidate: ``lif_scan``'s step
with the neuron's previous spike times the candidate's self-weight added to
its current.  Its kernel (``ataf_scan_kernel`` in the same source) replaces
no TPU kernel -- JAX steps ATA-F with ``jnp`` under ``vmap`` -- and takes the
place of the port's elementwise step loop; like ``lif_scan`` it is bound by
bytes.  Its plain version is :func:`ataf_scan_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.core.fixed_point import int_max, int_min
from repro_torch.kernels import build, work
from repro_torch.kernels.lif_scan.ref import ataf_scan_ref, lif_scan_ref

__all__ = ["lif_scan", "ataf_scan"]

_INT32_MIN, _INT32_MAX = int_min(32), int_max(32)


def lif_scan(
    currents: torch.Tensor,  # int32 [T, B, N], or [P, T, B, N] with a candidate axis
    *,
    theta_q,
    decay_k,
    u_bits: int = 16,
    reset_to_zero: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused LIF window scan. Returns (spikes int32 [T, B, N], final_u int32 [B, N]).

    ``theta_q`` may be an int or an int32 scalar tensor, ``decay_k`` an int
    in [0, 256]; on the card both reach the kernel as one-element device
    tensors, so a tensor theta is never read on the host.  With a candidate
    axis (currents [P, T, B, N]) ``theta_q`` and ``decay_k`` are int32 [P]
    tensors beside the currents (``decay_k`` the packed 9-bit DecayRate
    register: 256 and above is the bypass), and the results gain the
    leading P.
    """
    if currents.dim() == 4:
        return _lif_scan_population(currents, theta_q, decay_k, u_bits, reset_to_zero)
    if currents.dim() != 3:
        raise ValueError(f"lif_scan: currents must be [T, B, N], got {tuple(currents.shape)}")
    if not 0 <= decay_k <= 256:
        raise ValueError(f"lif_scan: decay_k must be in [0, 256], got {decay_k}")
    _check_u_bits(u_bits)
    if currents.device.type == "cpu":
        with _call(currents[None]):
            return lif_scan_ref(currents, theta_q, decay_k, u_bits, reset_to_zero)
    _check_card(currents)
    dev = currents.device
    if isinstance(theta_q, torch.Tensor):
        if theta_q.numel() != 1 or theta_q.dtype != torch.int32:
            raise ValueError("lif_scan: a tensor theta_q must be one int32 value")
        theta = theta_q.reshape(1).to(dev)
    else:
        if not _INT32_MIN <= theta_q <= _INT32_MAX:
            raise ValueError(f"lif_scan: theta_q={theta_q} is outside int32")
        theta = torch.full((1,), theta_q, dtype=torch.int32, device=dev)
    k = torch.full((1,), decay_k, dtype=torch.int32, device=dev)
    spikes, u_final = _launch(currents[None], theta, k, u_bits, reset_to_zero)
    return spikes[0], u_final[0]


lif_scan.launches = 0


def _call(currents: torch.Tensor):
    """The work of a scan of [P, T, B, N] currents: the currents read, the
    spikes and the final membrane written, theta and the decay register read
    once a candidate; 12 operations per element and step (saturating add,
    compare, subtract, select).  The decay's shift-adds depend on the
    registers, which live on the card, so they are left out."""
    P, T, B, N = currents.shape
    nbytes = 4 * (2 * P * T * B * N + P * B * N + 2 * P)
    return work.kernel("lif_scan", 12 * P * T * B * N, nbytes, (currents,))


def _check_u_bits(u_bits: int, what: str = "lif_scan") -> None:
    if not 2 <= u_bits <= 31:
        raise ValueError(f"{what}: u_bits must be in [2, 31], got {u_bits}")


def _check_card(currents: torch.Tensor, what: str = "lif_scan") -> None:
    if currents.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {currents.device}")
    if currents.dtype != torch.int32 or not currents.is_contiguous():
        raise ValueError(f"{what}: currents must be contiguous int32")


def _check_grid(P: int, what: str) -> None:
    if P > 65535:
        raise ValueError(f"{what}: {P} candidates exceed the kernel's grid (65535)")


def _registers(what: str, currents: torch.Tensor, **regs) -> list[torch.Tensor]:
    """The per-candidate registers of a scan of [P, T, B, N] currents, each
    checked to be int32 [P] beside the currents, made contiguous."""
    P = currents.shape[0]
    out = []
    for name, t in regs.items():
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != (P,) or t.dtype != torch.int32:
            raise ValueError(f"{what}: with currents [P, T, B, N] {name} must be int32 [{P}]")
        if t.device != currents.device:
            raise ValueError(f"{what}: {name} on {t.device}, currents on {currents.device}")
        out.append(t.contiguous())
    return out


def _lif_scan_population(currents, theta_q, decay_k, u_bits, reset_to_zero):
    """The candidate-axis form of :func:`lif_scan`: P windows, one launch."""
    regs = _registers("lif_scan", currents, theta_q=theta_q, decay_k=decay_k)
    _check_u_bits(u_bits)
    if currents.device.type == "cpu":
        with _call(currents):
            return lif_scan_ref(currents, theta_q, decay_k, u_bits, reset_to_zero)
    _check_card(currents)
    return _launch(currents, *regs, u_bits, reset_to_zero)


def _launch(currents, theta, k, u_bits, reset_to_zero):
    """One kernel launch over [P, T, B, N] currents on the card, theta and
    the register int32 [P] on the same card."""
    P, T, B, N = currents.shape
    _check_grid(P, "lif_scan")
    with _call(currents):
        spikes = torch.empty(P, T, B, N, dtype=torch.int32, device=currents.device)
        u_final = torch.empty(P, B, N, dtype=torch.int32, device=currents.device)
        launch = build.entry("lif_scan", "lif_scan_launch", 5, 6)
        with torch.cuda.device(currents.device):
            stream = torch.cuda.current_stream(currents.device).cuda_stream
            code = launch(
                currents.data_ptr(), spikes.data_ptr(), u_final.data_ptr(), theta.data_ptr(),
                k.data_ptr(), P, T, B * N, int_min(u_bits), int_max(u_bits), int(reset_to_zero),
                stream,
            )
            build.check(code, "lif_scan")
    lif_scan.launches += 1
    return spikes, u_final


def ataf_scan(
    currents: torch.Tensor,  # int32 [P, T, B, N]
    *,
    w_self: torch.Tensor,
    theta_q: torch.Tensor,
    decay_k: torch.Tensor,
    u_bits: int = 16,
    reset_to_zero: bool = False,
) -> torch.Tensor:
    """P candidates' ATA-F IF/LIF windows from zero state in one launch.
    Returns the spikes int32 [P, T, B, N].

    ``w_self``, ``theta_q`` and ``decay_k`` are int32 [P] tensors beside the
    currents: each candidate's self-weight register, threshold and packed
    9-bit DecayRate register (256 and above is the bypass).  Per step,
    ``I[t] + prev_spk * w_self`` then ``u + acc`` wrap in int32 before the
    ``u_bits`` saturation, as ``_integrate_acc`` does; the rest is
    :func:`lif_scan`'s step.
    """
    if currents.dim() != 4:
        raise ValueError(f"ataf_scan: currents must be [P, T, B, N], got {tuple(currents.shape)}")
    regs = _registers("ataf_scan", currents, w_self=w_self, theta_q=theta_q, decay_k=decay_k)
    _check_u_bits(u_bits, "ataf_scan")
    if currents.device.type == "cpu":
        with _ataf_call(currents):
            return ataf_scan_ref(currents, *regs, u_bits, reset_to_zero)
    _check_card(currents, "ataf_scan")
    P, T, B, N = currents.shape
    _check_grid(P, "ataf_scan")
    w, theta, k = regs
    with _ataf_call(currents):
        spikes = torch.empty(P, T, B, N, dtype=torch.int32, device=currents.device)
        launch = build.entry("lif_scan", "ataf_scan_launch", 5, 6)
        with torch.cuda.device(currents.device):
            stream = torch.cuda.current_stream(currents.device).cuda_stream
            code = launch(
                currents.data_ptr(), spikes.data_ptr(), w.data_ptr(), theta.data_ptr(),
                k.data_ptr(), P, T, B * N, int_min(u_bits), int_max(u_bits), int(reset_to_zero),
                stream,
            )
            build.check(code, "ataf_scan")
    ataf_scan.launches += 1
    return spikes


ataf_scan.launches = 0


def _ataf_call(currents: torch.Tensor):
    """The work of an ATA-F scan of [P, T, B, N] currents, counted as
    :func:`_call` counts ``lif_scan``'s: the currents read and the spikes
    written, the self-weight, theta and the decay register read once a
    candidate; 14 operations per element and step (``lif_scan``'s 12, and the
    self-feedback's select and add)."""
    P, T, B, N = currents.shape
    nbytes = 4 * (2 * P * T * B * N + 3 * P)
    return work.kernel("ataf_scan", 14 * P * T * B * N, nbytes, (currents,))
