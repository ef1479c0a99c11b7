"""Per-core (= per-layer) SNN semantics: the bit-exact integer datapath.

One Flexi-NeurA core implements one layer; a time step runs in two phases
(paper section 4.1.5):

  Phase A -- spike integration: incoming spikes add their synaptic-weight
  rows into ``U`` (IF/LIF) or ``I_syn`` (Synaptic); the previous step's own
  spikes add the recurrent weights (dense ``W_rec`` for ATA-T, one shared
  self-weight for ATA-F).

  Phase B -- leak / spike generation, per neuron:
      Synaptic:  u_tmp = sat(U + I_syn)           (otherwise u_tmp = U)
      if u_tmp >= theta:  spike; U <- reset(u_tmp)
      else:               U <- CG_beta(u_tmp)
      Synaptic:  I_syn <- CG_alpha(I_syn)

Every exact int32 product here goes through the ``spike_matmul`` wrapper:
the CUDA kernel for tensors on the card, int32 ``torch.matmul`` on the CPU.
The float (training) step, :func:`float_layer_step`, keeps the same phase
order with a surrogate spike function; its products are float32
``torch.matmul`` (JAX computes them outside any Pallas kernel too).

A population of precision candidates (the DSE sweep) runs through the same
functions with a leading candidate axis on every tensor: state [P, batch,
n_out], ``w_ff`` [P, n_in, n_out], an ATA-T ``w_rec`` [P, n_out, n_out], and
``theta_q``, an ATA-F ``w_rec`` and the decay registers as [P, 1, 1], so
they broadcast against the state (:func:`int_layer_step_dynamic`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core import coeff_gen
from repro_torch.core.coeff_gen import DecayCode
from repro_torch.core.fixed_point import saturate
from repro_torch.kernels.quant_matmul.spike_matmul import spike_matmul

__all__ = [
    "NeuronModel",
    "ResetMode",
    "Topology",
    "LayerConfig",
    "IntLayerParams",
    "FloatLayerParams",
    "LayerState",
    "int_layer_init",
    "float_layer_init",
    "int_layer_step",
    "float_layer_step",
    "int_layer_step_dynamic",
    "int_phase_a",
    "int_phase_b",
    "int_layer_window",
    "int_layer_window_carry",
    "int_layer_window_from_currents",
    "fused_eligible",
]


class NeuronModel(str, enum.Enum):
    IF = "if"  # realised as LIF with the CG bypass path (no leak)
    LIF = "lif"
    SYNAPTIC = "synaptic"


class ResetMode(str, enum.Enum):
    ZERO = "zero"
    SUBTRACT = "subtract"


class Topology(str, enum.Enum):
    FF = "ff"  # feed-forward only
    ATA_F = "ata_f"  # self-feedback only (one shared weight register)
    ATA_T = "ata_t"  # dense intra-layer recurrence


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    """Design-time parameters of one Flexi-NeurA core (pre-synthesis)."""

    n_in: int
    n_out: int
    neuron: NeuronModel = NeuronModel.LIF
    topology: Topology = Topology.FF
    reset: ResetMode = ResetMode.SUBTRACT
    # Fixed-point widths (the Flex-plorer DSE knobs).
    w_bits: int = 6
    w_rec_bits: int = 6
    u_bits: int = 16
    i_bits: int = 16
    leak_bits: int = 8
    # Float dynamics (trained / user-chosen); quantized on deployment.
    beta: float = 0.95  # membrane leak
    alpha: float = 0.90  # synaptic-current leak (Synaptic model only)
    threshold: float = 1.0

    def __post_init__(self):
        if self.n_in <= 0 or self.n_out <= 0:
            raise ValueError("layer sizes must be positive")
        if self.n_out > 256 or self.n_in > 256:
            raise ValueError(
                "a Flexi-NeurA core supports at most 256 neurons per layer "
                f"(got n_in={self.n_in}, n_out={self.n_out}); split the layer "
                "across cores or reduce it as the paper does for its datasets"
            )
        for name in ("w_bits", "w_rec_bits"):
            b = getattr(self, name)
            if not 2 <= b <= 16:
                raise ValueError(f"{name} must be in [2, 16], got {b}")
        for name in ("u_bits", "i_bits"):
            b = getattr(self, name)
            if not 4 <= b <= 24:
                raise ValueError(f"{name} must be in [4, 24], got {b}")

    @property
    def is_recurrent(self) -> bool:
        return self.topology in (Topology.ATA_F, Topology.ATA_T)

    @property
    def effective_beta(self) -> float:
        # The IF model is the LIF datapath with the CG bypass engaged.
        return 1.0 if self.neuron == NeuronModel.IF else self.beta

    def beta_code(self) -> DecayCode:
        return coeff_gen.encode_decay(self.effective_beta, self.leak_bits)

    def alpha_code(self) -> DecayCode:
        return coeff_gen.encode_decay(self.alpha, self.leak_bits)


class IntLayerParams(NamedTuple):
    """Quantized runtime parameters (the SPI-loaded memories/registers)."""

    w_ff: torch.Tensor  # int32 [n_in, n_out]
    w_rec: torch.Tensor  # int32 [n_out, n_out] (ATA-T) | [] scalar (ATA-F) | [0] (FF)
    theta_q: torch.Tensor  # int32 scalar


class FloatLayerParams(NamedTuple):
    w_ff: torch.Tensor  # f32 [n_in, n_out]
    w_rec: torch.Tensor  # f32 [n_out, n_out] | scalar | [0]
    theta: torch.Tensor  # f32 scalar


class LayerState(NamedTuple):
    u: torch.Tensor  # membrane potential  [batch, n_out]
    i_syn: torch.Tensor  # synaptic current [batch, n_out] (zeros if unused)
    prev_spk: torch.Tensor  # this layer's spikes from the previous step [batch, n_out]


def int_layer_init(cfg: LayerConfig, batch: int, device: str | torch.device = "cuda") -> LayerState:
    # Three distinct buffers: the serving lane pool updates them in place.
    dev = resolve_device(device)
    z = lambda: torch.zeros(batch, cfg.n_out, dtype=torch.int32, device=dev)
    return LayerState(u=z(), i_syn=z(), prev_spk=z())


def float_layer_init(
    cfg: LayerConfig, batch: int, device: str | torch.device = "cuda"
) -> LayerState:
    dev = resolve_device(device)
    z = lambda: torch.zeros(batch, cfg.n_out, dtype=torch.float32, device=dev)
    return LayerState(u=z(), i_syn=z(), prev_spk=z())


def _integrate_acc(cfg: LayerConfig, params: IntLayerParams, state: LayerState, ff_acc):
    """Phase A given the step's feed-forward accumulation ``ff_acc``.

    Adds the recurrent contribution (the previous step's own spikes) and
    commits the total into the integration target register.  Saturation is
    applied once, after the full step's accumulation, so any exact method of
    computing ``ff_acc`` yields identical state.
    """
    acc = ff_acc
    if cfg.topology == Topology.ATA_T:
        acc = acc + spike_matmul(
            state.prev_spk.contiguous(), params.w_rec, counter="spike_matmul.rec_macs"
        )
    elif cfg.topology == Topology.ATA_F:
        acc = acc + state.prev_spk * params.w_rec
    if cfg.neuron == NeuronModel.SYNAPTIC:
        return state.u, saturate(state.i_syn + acc, cfg.i_bits)
    return saturate(state.u + acc, cfg.u_bits), state.i_syn


def int_phase_a(cfg: LayerConfig, params: IntLayerParams, state: LayerState, s_in):
    """Phase A: accumulate weighted spikes into the integration target."""
    s_in_i = s_in.to(torch.int32).contiguous()
    ff_acc = spike_matmul(s_in_i, params.w_ff)  # {0,1} x int32, exact
    return _integrate_acc(cfg, params, state, ff_acc)


def int_phase_b(cfg: LayerConfig, params: IntLayerParams, u, i_syn, decay_u, decay_i):
    """Phase B (leak / spike / reset); ``decay_u`` / ``decay_i`` are the CG
    applications, so this is the single copy of the spike/reset/leak numerics."""
    if cfg.neuron == NeuronModel.SYNAPTIC:
        u_tmp = saturate(u + i_syn, cfg.u_bits)
    else:
        u_tmp = u

    spk = (u_tmp >= params.theta_q).to(torch.int32)
    if cfg.reset == ResetMode.ZERO:
        u_reset = torch.zeros_like(u_tmp)
    else:
        u_reset = saturate(u_tmp - params.theta_q, cfg.u_bits)
    u_leak = saturate(decay_u(u_tmp), cfg.u_bits)
    u_new = torch.where(spk == 1, u_reset, u_leak)

    if cfg.neuron == NeuronModel.SYNAPTIC:
        i_new = saturate(decay_i(i_syn), cfg.i_bits)
    else:
        i_new = i_syn

    return LayerState(u=u_new, i_syn=i_new, prev_spk=spk), spk


def _decays(cfg: LayerConfig):
    beta_code, alpha_code = cfg.beta_code(), cfg.alpha_code()
    return (
        lambda x: coeff_gen.apply_decay(x, beta_code),
        lambda x: coeff_gen.apply_decay(x, alpha_code),
    )


def int_layer_step(
    cfg: LayerConfig, params: IntLayerParams, state: LayerState, s_in
) -> tuple[LayerState, torch.Tensor]:
    """One bit-exact hardware time step. Returns (new_state, spikes int32)."""
    u, i_syn = int_phase_a(cfg, params, state, s_in)
    return int_phase_b(cfg, params, u, i_syn, *_decays(cfg))


def _traced_decays(beta_register, alpha_register):
    return (
        lambda x: coeff_gen.apply_decay_traced(x, beta_register),
        lambda x: coeff_gen.apply_decay_traced(x, alpha_register),
    )


def int_layer_step_dynamic(
    cfg: LayerConfig,
    params: IntLayerParams,
    state: LayerState,
    s_in,
    beta_register,
    alpha_register,
) -> tuple[LayerState, torch.Tensor]:
    """Bit-exact step with the DecayRate registers as int32 tensors (the
    population DSE path).

    Identical numerics to :func:`int_layer_step`, but every CG tap is gated
    arithmetically by the packed 9-bit ``DecayCode.decay_rate_register``, so
    candidates whose ``leak_bits`` differ run in one call: with a candidate
    axis the registers are [P, 1, 1] (see the module docstring), and
    ``s_in`` is [batch, n_in] (shared) or [P, batch, n_in].
    """
    u, i_syn = int_phase_a(cfg, params, state, s_in)
    return int_phase_b(cfg, params, u, i_syn, *_traced_decays(beta_register, alpha_register))


def _integrate_float(cfg: LayerConfig, params: FloatLayerParams, state: LayerState, s_in):
    acc = torch.matmul(s_in.to(torch.float32), params.w_ff)
    if cfg.topology == Topology.ATA_T:
        acc = acc + torch.matmul(state.prev_spk, params.w_rec)
    elif cfg.topology == Topology.ATA_F:
        acc = acc + state.prev_spk * params.w_rec
    if cfg.neuron == NeuronModel.SYNAPTIC:
        return state.u, state.i_syn + acc
    return state.u + acc, state.i_syn


def float_layer_step(
    cfg: LayerConfig, params: FloatLayerParams, state: LayerState, s_in, spike_fn
) -> tuple[LayerState, torch.Tensor]:
    """Differentiable step with the *same phase ordering* as the hardware.

    ``spike_fn(u - theta)`` must return {0,1} forward with a surrogate
    gradient (see ``repro_torch.snn.surrogate``).  Keeping the hardware's
    decay-or-reset ordering at train time removes the train/deploy semantic
    gap that a vanilla SNN-Torch unrolling would leave; the reset and the
    leak are mixed arithmetically, so the surrogate gradient flows through
    the branch selector.
    """
    u, i_syn = _integrate_float(cfg, params, state, s_in)
    u_tmp = u + i_syn if cfg.neuron == NeuronModel.SYNAPTIC else u

    spk = spike_fn(u_tmp - params.theta)
    if cfg.reset == ResetMode.ZERO:
        u_reset = torch.zeros_like(u_tmp)
    else:
        u_reset = u_tmp - params.theta
    u_new = spk * u_reset + (1.0 - spk) * (cfg.effective_beta * u_tmp)

    i_new = cfg.alpha * i_syn if cfg.neuron == NeuronModel.SYNAPTIC else i_syn
    return LayerState(u=u_new, i_syn=i_new, prev_spk=spk), spk


def fused_eligible(cfg: LayerConfig) -> bool:
    """True when a layer's window can run through the fused kernel path
    (``spike_integrate`` + ``lif_scan``): feed-forward IF/LIF cores.
    Recurrent topologies and the Synaptic model stay on the step semantics."""
    return cfg.topology == Topology.FF and cfg.neuron in (NeuronModel.IF, NeuronModel.LIF)


def _stack_steps(spikes: list, batch: int, n_out: int, device) -> torch.Tensor:
    if not spikes:
        return torch.zeros(0, batch, n_out, dtype=torch.int32, device=device)
    return torch.stack(spikes)


def int_layer_window(cfg: LayerConfig, params: IntLayerParams, raster) -> torch.Tensor:
    """Run one layer over a whole window. ``raster``: int [T, batch, n_in].

    Returns the output spike raster int32 [T, batch, n_out]; numerics are
    exactly ``int_layer_step`` iterated over the window.
    """
    state = int_layer_init(cfg, raster.shape[1], device=raster.device)
    spikes = []
    for s_t in raster.to(torch.int32):
        state, spk = int_layer_step(cfg, params, state, s_t)
        spikes.append(spk)
    return _stack_steps(spikes, raster.shape[1], cfg.n_out, raster.device)


def int_layer_window_carry(
    cfg: LayerConfig, params: IntLayerParams, state: LayerState, ff_currents, live=None
) -> tuple[LayerState, torch.Tensor]:
    """Carried-state window over precomputed FF currents [T, batch, n_out].

    Starts from ``state`` and returns the state after the window alongside
    the spikes, so two consecutive chunks are bit-identical to one longer
    window.  ``live`` (optional bool [T, batch]) freezes a batch element's
    carry once its liveness goes False: the step still computes, but the
    committed state is the pre-step state, so the returned carry is exactly
    the state after that element's last live step.  Spikes emitted on dead
    steps are garbage-but-harmless; callers mask recorded outputs.
    """
    return _scan_currents(cfg, params, state, ff_currents, _decays(cfg), live)


def _scan_currents(cfg, params, state, ff_currents, decays, live=None):
    """The step loop of :func:`int_layer_window_carry` with the CG
    applications ``decays`` = (decay_u, decay_i) given: static codes, or the
    traced registers of a population."""
    decay_u, decay_i = decays
    spikes = []
    for t, c_t in enumerate(ff_currents.to(torch.int32)):
        u, i_syn = _integrate_acc(cfg, params, state, c_t)
        new_state, spk = int_phase_b(cfg, params, u, i_syn, decay_u, decay_i)
        if live is not None:
            live_t = live[t][:, None]  # [batch, 1]
            new_state = LayerState(
                *(torch.where(live_t, n, o) for n, o in zip(new_state, state))
            )
        state = new_state
        spikes.append(spk)
    if not spikes:
        return state, torch.zeros(ff_currents.shape, dtype=torch.int32, device=ff_currents.device)
    return state, torch.stack(spikes)


def int_layer_window_from_currents(
    cfg: LayerConfig, params: IntLayerParams, ff_currents
) -> torch.Tensor:
    """Run one layer over a window of precomputed FF integration currents.

    ``ff_currents``: int32 [T, batch, n_out], the per-step feed-forward
    accumulation however it was computed; recurrence and phase B run per
    step, so every neuron model / topology / reset mode is covered.
    """
    state0 = int_layer_init(cfg, ff_currents.shape[1], device=ff_currents.device)
    _, spikes = int_layer_window_carry(cfg, params, state0, ff_currents)
    return spikes
