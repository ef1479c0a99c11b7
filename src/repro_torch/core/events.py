"""AER event packets and the strict event-driven reference simulator.

Port of ``repro/core/events.py`` (numpy only, unchanged): the packet codec
and :class:`EventDrivenCore`, the per-event scalar model that pins the
port's vectorised ``int_layer_step`` to the hardware contract
(``tests/test_torch_events.py``).

Packet formats (paper section 4).  The paper does not pin the exact
control-payload encodings, so the concrete words below are *this repo's*
contract -- they are asserted verbatim by ``test_torch_events.py::
test_packet_words_pinned``, so this docstring and the codec cannot drift
apart without a test failure:

* ASPL -- Address of Spike in Previous Layer, 9 bits:
  ``{control=0, addr[7:0]}``; the word *is* the address
  (``encode_packet(ASPL, 0xAB) == 0x0AB``).
* ASCL -- Address of Spike in Current Layer, 8 bits: the bare address
  (``0xAB``).  The recurrent path has its own FIFO, so no control bit is
  needed; ``decode_packet(word, recurrent_path=True)`` disambiguates.
* EOTS -- End Of Time Step: control word ``0x100`` (control=1, payload 0).
* EOIN -- End Of INput:   control word ``0x101`` (control=1, payload 1).

EOIN lazy-reset semantics (asserted by ``test_torch_events.py::
test_eoin_lazy_reset_zeroes_state_after_spike_generation``): the EOIN step
is processed *normally* -- integration, leak, threshold compare and spike
emission all happen -- but during the leak/spike sweep the state writeback
is replaced by zeros (``U <- 0``, ``I_syn <- 0``).  Spikes of the final
step are therefore real outputs, while the next sample starts from virgin
state without spending a separate reset sweep.

:class:`EventDrivenCore` is a deliberately scalar, per-event Python/NumPy
model of one core: events are integrated one at a time with *per-event
saturation*, in arrival order, exactly as the RTL's FF-Integ/REC-Integ
microstates do.  It exists to pin the vectorised ``int_layer_step`` to the
hardware contract: property tests (``test_torch_events.py``) assert both
produce identical trajectories whenever no intermediate accumulation
saturates (and the strict model is the ground truth when one does).  Its
``cycle_count`` (one cycle per swept neuron visit) is the same accounting
rule the analytic latency model in ``repro_torch.core.hw_model.step_cycles``
vectorises.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.core.fixed_point import int_max, int_min
from repro_torch.core.snn_layer import LayerConfig, NeuronModel, ResetMode, Topology

__all__ = [
    "PacketKind",
    "encode_packet",
    "decode_packet",
    "raster_to_packets",
    "EventDrivenCore",
]

_CONTROL_BIT = 1 << 8


class PacketKind(str, enum.Enum):
    ASPL = "aspl"
    ASCL = "ascl"
    EOTS = "eots"
    EOIN = "eoin"


def encode_packet(kind: PacketKind, addr: int = 0) -> int:
    if kind == PacketKind.ASPL:
        if not 0 <= addr < 256:
            raise ValueError(f"ASPL address out of range: {addr}")
        return addr
    if kind == PacketKind.ASCL:
        if not 0 <= addr < 256:
            raise ValueError(f"ASCL address out of range: {addr}")
        return addr  # 8-bit packet on the recurrent path; context disambiguates
    if kind == PacketKind.EOTS:
        return _CONTROL_BIT | 0
    if kind == PacketKind.EOIN:
        return _CONTROL_BIT | 1
    raise ValueError(kind)


def decode_packet(word: int, recurrent_path: bool = False):
    if word & _CONTROL_BIT:
        payload = word & 0xFF
        return (PacketKind.EOIN if payload == 1 else PacketKind.EOTS), payload
    return (PacketKind.ASCL if recurrent_path else PacketKind.ASPL), word & 0xFF


def raster_to_packets(raster: np.ndarray) -> list[list[int]]:
    """Dense spike raster [T, n] -> per-step ASPL packet lists (+EOTS/EOIN).

    The driver acts as the input layer: it walks each time step, emits one
    ASPL per active source (ascending address = arrival order used by the
    reference core), then EOTS -- or EOIN after the final step.
    """
    raster = np.asarray(raster)
    T = raster.shape[0]
    steps = []
    for t in range(T):
        pkts = [encode_packet(PacketKind.ASPL, int(a)) for a in np.nonzero(raster[t])[0]]
        pkts.append(
            encode_packet(PacketKind.EOIN if t == T - 1 else PacketKind.EOTS)
        )
        steps.append(pkts)
    return steps


@dataclasses.dataclass
class EventDrivenCore:
    """Strict per-event, per-neuron scalar model of one core (ground truth)."""

    cfg: LayerConfig
    w_ff: np.ndarray  # int [n_in, n_out]
    w_rec: np.ndarray  # int [n_out, n_out] | scalar | empty
    theta_q: int

    def __post_init__(self):
        self.u = np.zeros(self.cfg.n_out, np.int64)
        self.i_syn = np.zeros(self.cfg.n_out, np.int64)
        self.prev_spk = np.zeros(self.cfg.n_out, np.int64)
        self._beta = self.cfg.beta_code()
        self._alpha = self.cfg.alpha_code()
        self.cycle_count = 0  # swept-neuron visits; feeds the latency model

    # -- helpers ---------------------------------------------------------
    def _sat(self, x: int, bits: int) -> int:
        return int(min(max(x, int_min(bits)), int_max(bits)))

    def _decay(self, x: int, code) -> int:
        if code.bypass:
            return int(x)
        acc = 0
        for shift in range(1, 9):
            if (code.k >> (8 - shift)) & 1:
                acc += int(np.asarray(x, np.int64)) >> shift
        return acc

    def _integrate_one(self, neuron: int, w: int):
        if self.cfg.neuron == NeuronModel.SYNAPTIC:
            self.i_syn[neuron] = self._sat(self.i_syn[neuron] + w, self.cfg.i_bits)
        else:
            self.u[neuron] = self._sat(self.u[neuron] + w, self.cfg.u_bits)
        self.cycle_count += 1

    # -- phases ----------------------------------------------------------
    def integrate_aspl(self, src: int):
        """FF-Integ: sweep all destination neurons for one input spike."""
        for n in range(self.cfg.n_out):
            self._integrate_one(n, int(self.w_ff[src, n]))

    def integrate_ascl(self, src: int):
        """REC-Integ: dense sweep (ATA-T) or self-only update (ATA-F)."""
        if self.cfg.topology == Topology.ATA_T:
            for n in range(self.cfg.n_out):
                self._integrate_one(n, int(self.w_rec[src, n]))
        elif self.cfg.topology == Topology.ATA_F:
            self._integrate_one(src, int(self.w_rec))

    def leak_spike_phase(self, lazy_reset: bool = False) -> list[int]:
        """Sequential neuron sweep; returns addresses of spiking neurons.

        With ``lazy_reset`` (the EOIN step) the sweep computes spikes
        normally but writes zeros back instead of the decayed/reset state --
        see the module docstring for the pinned semantics.
        """
        fired = []
        for n in range(self.cfg.n_out):
            if self.cfg.neuron == NeuronModel.SYNAPTIC:
                u_tmp = self._sat(self.u[n] + self.i_syn[n], self.cfg.u_bits)
            else:
                u_tmp = int(self.u[n])
            if u_tmp >= self.theta_q:
                fired.append(n)
                if self.cfg.reset == ResetMode.ZERO:
                    self.u[n] = 0
                else:
                    self.u[n] = self._sat(u_tmp - self.theta_q, self.cfg.u_bits)
            else:
                self.u[n] = self._sat(self._decay(u_tmp, self._beta), self.cfg.u_bits)
            if self.cfg.neuron == NeuronModel.SYNAPTIC:
                self.i_syn[n] = self._sat(
                    self._decay(self.i_syn[n], self._alpha), self.cfg.i_bits
                )
            self.cycle_count += 1
        if lazy_reset:
            # EOIN: zeros are written directly instead of the computed state.
            self.u[:] = 0
            self.i_syn[:] = 0
        return fired

    def step(self, aspl_sources: list[int], last: bool = False) -> list[int]:
        """Process one full time step worth of packets; returns fired addrs."""
        for src in aspl_sources:
            self.integrate_aspl(src)
        # EOTS/EOIN: recurrent events from the previous step, then leak/spike.
        if self.cfg.is_recurrent:
            for src in np.nonzero(self.prev_spk)[0]:
                self.integrate_ascl(int(src))
        fired = self.leak_spike_phase(lazy_reset=last)
        self.prev_spk[:] = 0
        if not last:
            self.prev_spk[fired] = 1
        return fired
