"""Flex-plorer cost functions (paper Eqs. 4-7, plus an event-aware perf term).

    HwCost    = C_H * (C_LUT*LUT_n + C_FF*FF_n + C_BRAM*BRAM_n)
    AccCost   = C_A * (1 - hardware_aware_accuracy)
    PerfCost  = C_P * (C_LAT*lat/lat_target + C_E*energy/energy_target
                       + C_BW*congestion)
    TotalCost = HwCost + AccCost + PerfCost    with C_H + C_A + C_P = 1,
                C_LUT + C_FF + C_BRAM = 1,  C_LAT + C_E + C_BW = 1

Resource terms are normalised by the target device capacity (default: the
paper's Xilinx Zynq-7000 XC7Z020).  The perf term normalises *measured*
event-driven latency/energy (``hw_model.design_point`` at the candidate's
simulated traffic) against a target budget (default: the paper's MNIST
design point, 1.1 ms / 0.12 mJ) -- this is what lets the annealer trade
precision for realistic event-dependent latency instead of worst-case
dense cycles.  ``C_P`` defaults to 0, which recovers the paper's exact
two-term objective.

The ``C_BW * congestion`` term is the memory-bandwidth bottleneck model
(after the neuromorphic bottleneck-modeling analysis, arxiv 2511.21549):
``congestion`` is how far the candidate's measured per-layer weight/state
traffic demand (``hw_model.bandwidth_profile``) exceeds the device's
sustainable memory bandwidth (``DeviceCapacity.mem_bw_bytes_s``), zero
while the design fits.  ``C_BW`` defaults to 0 so every pre-existing
score is reproduced bit-identically.

The port's copy of ``repro/core/flexplorer/cost.py`` (plain Python over the
port's ``hw_model``), so the same candidate gets the same float cost.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hw_model import CoreResources

__all__ = [
    "DeviceCapacity",
    "XC7Z020",
    "CostWeights",
    "PerfTargets",
    "hw_cost",
    "acc_cost",
    "perf_cost",
    "total_cost",
]


@dataclasses.dataclass(frozen=True)
class DeviceCapacity:
    """Target-device resource budget the cost terms normalise against.

    ``mem_bw_bytes_s`` is the sustainable external-memory bandwidth the
    congestion term compares measured traffic demand against.  The default
    is a single Zynq-7000 AXI HP port into DDR3 (~1.2 GB/s sustained of
    the 64-bit x 150 MHz theoretical peak) -- the paper's MNIST anchor
    design demands ~0.3 GB/s, comfortably uncongested, so the term only
    bites for high-precision multi-core configurations that actually
    saturate the port.
    """

    luts: float
    ffs: float
    brams: float
    name: str = "device"
    mem_bw_bytes_s: float = 1.2e9


XC7Z020 = DeviceCapacity(luts=53_200, ffs=106_400, brams=140, name="XC7Z020")


@dataclasses.dataclass(frozen=True)
class PerfTargets:
    """Latency/energy budgets the perf cost normalises against.

    Defaults are the paper's MNIST design point, so a perf cost of
    ``C_P`` means "exactly on the paper's published operating figures".
    """

    latency_s: float = 1.1e-3
    energy_j: float = 0.12e-3


@dataclasses.dataclass(frozen=True)
class CostWeights:
    c_hw: float = 0.5
    c_acc: float = 0.5
    c_perf: float = 0.0
    c_lut: float = 0.33
    c_ff: float = 0.33
    c_bram: float = 0.34
    c_lat: float = 0.5
    c_energy: float = 0.5
    # Memory-bandwidth congestion weight (arxiv 2511.21549).  Default 0:
    # the perf term is the paper-era latency/energy pair, bit-identically.
    c_bw: float = 0.0

    def __post_init__(self):
        if abs(self.c_hw + self.c_acc + self.c_perf - 1.0) > 1e-9:
            raise ValueError("C_H + C_A + C_P must equal 1 (paper Eq. 7; C_P = 0 there)")
        if abs(self.c_lut + self.c_ff + self.c_bram - 1.0) > 1e-9:
            raise ValueError("C_LUT + C_FF + C_BRAM must equal 1 (paper Eq. 7)")
        if abs(self.c_lat + self.c_energy + self.c_bw - 1.0) > 1e-9:
            raise ValueError("C_LAT + C_E + C_BW must equal 1 (C_BW = 0 pre-bottleneck-model)")


def hw_cost(res: CoreResources, w: CostWeights, dev: DeviceCapacity = XC7Z020) -> float:
    lut_n = res.lut / dev.luts
    ff_n = res.ff / dev.ffs
    bram_n = res.bram / dev.brams
    return w.c_hw * (w.c_lut * lut_n + w.c_ff * ff_n + w.c_bram * bram_n)


def acc_cost(hardware_aware_accuracy: float, w: CostWeights) -> float:
    return w.c_acc * (1.0 - hardware_aware_accuracy)


def perf_cost(
    latency_s: float,
    energy_j: float,
    w: CostWeights,
    targets: PerfTargets = PerfTargets(),
    bw_congestion: float = 0.0,
) -> float:
    """Event-aware performance cost: measured latency/energy vs budget.

    ``bw_congestion`` is the candidate's memory-bandwidth overshoot
    (``hw_model.BandwidthProfile.congestion``): 0 while measured traffic
    demand fits the device's ``mem_bw_bytes_s``, else the fractional
    excess.  Weighted by ``C_BW`` (default 0 => identical float sequence
    to the pre-bottleneck-model cost).
    """
    lat_n = latency_s / targets.latency_s
    e_n = energy_j / targets.energy_j
    inner = w.c_lat * lat_n + w.c_energy * e_n
    if w.c_bw:
        inner += w.c_bw * bw_congestion
    return w.c_perf * inner


def total_cost(
    res: CoreResources,
    accuracy: float,
    w: CostWeights,
    dev: DeviceCapacity = XC7Z020,
    latency_s: float | None = None,
    energy_j: float | None = None,
    targets: PerfTargets = PerfTargets(),
    bw_congestion: float = 0.0,
) -> float:
    total = hw_cost(res, w, dev) + acc_cost(accuracy, w)
    if w.c_perf:
        if latency_s is None or energy_j is None:
            raise ValueError(
                "total_cost: weights have c_perf > 0, so latency_s and "
                "energy_j are required (omitting them would silently drop "
                "the perf term and change the objective's scale)"
            )
        total += perf_cost(latency_s, energy_j, w, targets, bw_congestion=bw_congestion)
    return total
