"""Collective traffic and roofline terms (port of ``repro/distributed/hlo_analysis.py``).

JAX parses the compiled, SPMD-partitioned HLO text for its collectives; the
parser is kept here as it is, since a user may still hand in XLA's HLO.
The port's own collectives are counted as they run
(``distributed/spmd.py::count_collectives``), and both account each
collective with the same ring-algorithm cost, :func:`ring_wire_bytes`:

    all-reduce          2 * B * (g-1)/g      bytes on the wire per device
    all-gather          B * (g-1)/g          (B = full/gathered tensor bytes)
    reduce-scatter      B * (g-1)/g
    all-to-all          B * (g-1)/g
    collective-permute  B

``g`` is the group size, 2 where it is unknown.  Terms (seconds, per
device, from :data:`HW`, one NVIDIA H100 SXM):

    compute    = flops_per_device / peak_flops
    memory     = bytes_per_device / hbm_bw
    collective = wire_bytes_per_device / ici_bw
"""

from __future__ import annotations

import dataclasses
import re

__all__ = [
    "CollectiveStats",
    "HardwareConstants",
    "parse_collectives",
    "ring_wire_bytes",
    "roofline_terms",
    "HW",
]


@dataclasses.dataclass(frozen=True)
class HardwareConstants:
    """One device's rates and capacity.  The field names are JAX's (a TPU's
    ``ici_bw`` is its inter-chip link); here ``ici_bw`` is the card's
    NVLink and ``dcn_bw`` its share of the network between hosts.

    Defaults: the NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU data sheet,
    dense rates at the 700 W limit): bf16 tensor cores 989 TFLOP/s, HBM3
    3.35 TB/s, NVLink 4 900 GB/s per GPU in both directions (450 GB/s each
    way), one ConnectX-7 NDR 400 Gb/s NIC per GPU (50 GB/s), 80 GB of HBM
    (nominal, as JAX's 16e9 is for the v5e)."""

    peak_flops: float = 989e12  # bf16 dense, per card
    hbm_bw: float = 3.35e12  # bytes/s per card
    ici_bw: float = 450e9  # bytes/s per card per direction (NVLink 4)
    dcn_bw: float = 50e9  # bytes/s per card (NDR 400 Gb/s)
    hbm_bytes: float = 80e9  # capacity per card


HW = HardwareConstants()

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"\b(pred|[sufc]\d+|bf16)\[([0-9,]*)\]")
_GROUPS_V1_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")

#: op name -> wire-cost multiplier applied to the *full* tensor bytes
_COLLECTIVES = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "ragged-all-to-all": 1.0,
}


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def ring_wire_bytes(op: str, full_bytes: float, g: int | None) -> float:
    """Bytes one device puts on the wire for collective ``op`` (an HLO name
    of :data:`_COLLECTIVES`) over a group of ``g`` (2 where unknown or 1)
    on a tensor of ``full_bytes`` (the gathered side of a gather, the
    operand of a reduce)."""
    if not g or g <= 1:
        g = 2  # permutes / unknown: conservative
    ring = (g - 1) / g
    return _COLLECTIVES[op] * full_bytes * (1.0 if op == "collective-permute" else ring)


@dataclasses.dataclass
class CollectiveStats:
    per_device_wire_bytes: float
    by_op: dict  # op -> {count, wire_bytes}
    n_ops: int

    def summary(self) -> dict:
        return {
            "wire_bytes_per_device": self.per_device_wire_bytes,
            "n_ops": self.n_ops,
            "by_op": self.by_op,
        }


def parse_collectives(hlo_text: str) -> CollectiveStats:
    total = 0.0
    by_op: dict[str, dict] = {}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        m = re.search(r"=\s*(?:\([^)]*\)|\S+)\s+([a-z0-9-]+)\(", stripped)
        if not m:
            continue
        op = m.group(1)
        base = op.removesuffix("-start")
        if base not in _COLLECTIVES or op.endswith("-done"):
            continue
        shapes = _SHAPE_RE.findall(stripped.split("(", 1)[0])  # result side
        if not shapes:
            shapes = _SHAPE_RE.findall(stripped)
        if not shapes:
            continue
        # Full tensor = the largest shape on the line (gathered side for AG,
        # operand side for RS -- both appear in the HLO text).
        all_shapes = _SHAPE_RE.findall(stripped)
        full = max(_shape_bytes(d, s) for d, s in all_shapes)

        g = None
        m1 = _GROUPS_V1_RE.search(stripped)
        if m1:
            g = len(m1.group(1).split(","))
        else:
            m2 = _GROUPS_IOTA_RE.search(stripped)
            if m2:
                g = int(m2.group(2))
        wire = ring_wire_bytes(base, full, g)
        total += wire
        rec = by_op.setdefault(base, {"count": 0, "wire_bytes": 0.0})
        rec["count"] += 1
        rec["wire_bytes"] += wire
    return CollectiveStats(per_device_wire_bytes=total, by_op=by_op, n_ops=sum(r["count"] for r in by_op.values()))


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    wire_bytes_per_device: float,
    hw: HardwareConstants = HW,
) -> dict:
    compute_s = flops_per_device / hw.peak_flops
    memory_s = bytes_per_device / hw.hbm_bw
    collective_s = wire_bytes_per_device / hw.ici_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "roofline_bound_s": bound,
        "roofline_fraction": bound / total if total else 0.0,
    }
