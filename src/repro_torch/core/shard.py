"""Sharded multi-device execution of the Flexi-NeurA simulator (port of
``repro/core/shard.py``).

Two axes are independent by construction and therefore shard bit-exactly:

* the **sample axis** -- every step operation is elementwise or a product
  over the batch dimension, so samples never interact
  (:func:`run_int_sharded`, :func:`run_float_sharded`,
  :func:`run_int_batched_sharded`, and the serving engine's per-shard lane
  pools driven through :func:`wrap_lane_window`);
* the **candidate axis** of a population DSE sweep -- candidates share one
  static structure and differ only in quantized values / decay registers
  (:func:`run_int_population_sharded`).

JAX runs one ``shard_map`` program over the mesh.  Here the work axis is
split in Python: each shard's slice is made contiguous and placed on its
device, the serial code runs there (launching its kernels on that device's
current stream), and the outputs are concatenated on the mesh's first
device.  No collective runs, so a shard computes exactly the int32
arithmetic the serial path runs on that slice, and reassembly by
concatenation gives whole-result bit-exactness.  Parameters are copied to
each distinct device once per call (a device named by several shards gets
one copy).

A :class:`DeviceMesh` may name one device several times: four shards on
``cuda:0``, or on ``cpu``, partition, pad and reassemble exactly as four
cards would -- the port's counterpart of JAX's forced host device count.

Remainders and fallback rules (JAX's):

* a work axis that does not divide by the shard count is **zero-padded**
  (samples; zero-length lanes for the ragged runner) or **edge-repeated**
  (candidates) up to the next multiple, and the outputs are sliced back;
* a mesh of one device (or ``mesh=None``) runs the serial code path
  *verbatim*.

``resolve_mesh`` accepts what every ``mesh=`` keyword takes: ``None``
(serial), an ``int`` device count, ``"auto"`` (every local device) or a
:class:`DeviceMesh`.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core.backend import (
    InferenceBackend,
    SimRecord,
    _count,
    get_backend,
    run_int_batched,
    run_int_population,
)
from repro_torch.distributed import compat

__all__ = [
    "DeviceMesh",
    "make_mesh",
    "resolve_mesh",
    "pad_to_shards",
    "replicate",
    "split",
    "join",
    "host_bounds",
    "allgather_hosts",
    "run_int_sharded",
    "run_float_sharded",
    "run_int_population_sharded",
    "run_int_batched_sharded",
    "wrap_lane_window",
]

#: Default mesh axis name for the sharded work dimension.
SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh over the sharded work axis (samples/candidates/lanes).

    ``devices`` holds one ``torch.device`` per shard; a device may appear
    more than once.  ``n_shards == 1`` encodes the single-device fallback:
    the sharded entry points then run their serial code verbatim.  Frozen,
    and therefore hashable.  ``axis`` is a name only, kept so that JAX
    callers' ``make_mesh(axis=...)`` carries over: with no ``shard_map``,
    nothing in the port reads it.
    """

    devices: tuple[torch.device, ...]
    axis: str = SHARD_AXIS

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def pad(self, n: int) -> int:
        """How many pad entries bring ``n`` up to a multiple of the shards."""
        return -n % self.n_shards


def _local_devices() -> list[torch.device]:
    """Every CUDA card of this process, or the CPU on a host without one
    (JAX's local devices of the default platform)."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n else [torch.device("cpu")]


def make_mesh(
    data_parallel: int | None = None,
    *,
    devices=None,
    axis: str = SHARD_AXIS,
) -> DeviceMesh:
    """Build a 1-D :class:`DeviceMesh` over the first ``data_parallel`` devices.

    ``devices`` defaults to every CUDA card (``torch.cuda.device_count()``;
    the CPU where there is none), and ``data_parallel=None`` takes them
    all.  An explicit ``devices`` list may repeat a device (several shards
    on one card).  One device yields the serial fallback.  Asking for more
    devices than the list holds is an error -- callers that want
    best-effort clamp first (the serving engine does).
    """
    devices = _local_devices() if devices is None else [torch.device(d) for d in devices]
    n = len(devices) if data_parallel is None else int(data_parallel)
    if n < 1:
        raise ValueError(f"data_parallel must be >= 1, got {data_parallel}")
    if n > len(devices):
        raise ValueError(
            f"data_parallel={n} exceeds the {len(devices)} available devices; "
            "pass devices= naming a device more than once (several shards on one "
            "device) or clamp"
        )
    return DeviceMesh(devices=tuple(devices[:n]), axis=axis)


def resolve_mesh(mesh) -> DeviceMesh | None:
    """Normalise a user-facing ``mesh=`` value.

    ``None`` -> ``None`` (serial; the caller keeps its untouched code path),
    ``"auto"`` -> every local device, an ``int`` -> that many devices, a
    :class:`DeviceMesh` -> as given.
    """
    if mesh is None:
        return None
    if isinstance(mesh, DeviceMesh):
        return mesh
    if mesh == "auto":
        return make_mesh()
    if isinstance(mesh, int) and not isinstance(mesh, bool):
        return make_mesh(mesh)
    raise ValueError(
        f"cannot interpret mesh={mesh!r}; pass None, 'auto', an int device "
        "count or a DeviceMesh"
    )


def _serial(dmesh: DeviceMesh | None) -> bool:
    return dmesh is None or dmesh.n_shards == 1


def pad_to_shards(x: torch.Tensor, dmesh: DeviceMesh, axis: int, mode: str = "zero"):
    """Pad ``x`` along ``axis`` to a shard-divisible extent.

    ``mode="zero"`` appends zeros (samples: padded lanes are discarded after
    the run, and lane independence keeps them from perturbing real lanes);
    ``mode="edge"`` repeats the trailing entry (candidates: every lane must
    hold structurally valid parameters).
    """
    pad = dmesh.pad(x.shape[axis])
    if pad == 0:
        return x
    if mode == "zero":
        shape = list(x.shape)
        shape[axis] = pad
        tail = torch.zeros(shape, dtype=x.dtype, device=x.device)
    else:
        idx = torch.full((pad,), x.shape[axis] - 1, dtype=torch.int64, device=x.device)
        tail = x.index_select(axis, idx)
    return torch.cat([x, tail], dim=axis)


def _on(params, device: torch.device) -> list:
    """Per-layer parameter tuples with every tensor on ``device``."""
    return [type(p)(*(t.to(device) for t in p)) for p in params]


def replicate(params, dmesh: DeviceMesh) -> list:
    """``params`` (a per-layer list of parameter tuples) for each shard: one
    copy per distinct device of the mesh, shared by the shards on it (a
    device the parameters already live on takes no copy)."""
    copies = {}
    for dev in dmesh.devices:
        if dev not in copies:
            copies[dev] = _on(params, dev)
    return [copies[dev] for dev in dmesh.devices]


def split(x: torch.Tensor, dmesh: DeviceMesh, axis: int) -> list[torch.Tensor]:
    """``x`` (already shard-divisible along ``axis``) cut into one slice per
    shard, each made contiguous and placed on its shard's device.  The
    kernels refuse strided operands, and ``.to`` onto the device a tensor
    already lives on returns the same strided view -- hence the copy."""
    per = x.shape[axis] // dmesh.n_shards
    return [
        x.narrow(axis, i * per, per).contiguous().to(dev) for i, dev in enumerate(dmesh.devices)
    ]


def join(parts: list[torch.Tensor], dmesh: DeviceMesh, axis: int) -> torch.Tensor:
    """Concatenate the shards' outputs along ``axis`` on the mesh's first device."""
    home = dmesh.devices[0]
    return torch.cat([p.to(home) for p in parts], dim=axis)


def _join_records(recs: list[SimRecord], shards: list[torch.Tensor], dmesh, B: int) -> SimRecord:
    """One record of the true batch from the shards' records (sample axis)."""
    in_ev = [
        _count(s != 0) if r.input_events is None else r.input_events for r, s in zip(recs, shards)
    ]
    n_layers = len(recs[0].layer_spikes)
    return SimRecord(
        spike_counts=join([r.spike_counts for r in recs], dmesh, 0)[:B],
        layer_spikes=[
            join([r.layer_spikes[l] for r in recs], dmesh, 1)[:, :B] for l in range(n_layers)
        ],
        input_events=join(in_ev, dmesh, 1)[:, :B],
    )


# --------------------------------------------------------------------------
# Multi-host fan-out (fleet-scale DSE: candidate lists partitioned by process)
# --------------------------------------------------------------------------


def host_bounds(n: int, index: int | None = None, count: int | None = None) -> tuple[int, int]:
    """Half-open slice [lo, hi) of ``n`` work items owned by this process.

    ``n`` must be a multiple of the process count -- callers pad the work
    axis to the process x device multiple first (as :func:`pad_to_shards`
    pads to the device multiple), so every process runs an identically
    shaped sweep.  ``index``/``count`` override the process group's rank
    and size for testing.
    """
    if count is None:
        count = compat.process_count()
    if index is None:
        index = compat.process_index()
    if not 0 <= index < count:
        raise ValueError(f"host index {index} outside [0, {count})")
    if n % count:
        raise ValueError(
            f"work axis of {n} does not divide over {count} hosts; pad it "
            f"to a multiple first (see pad_to_shards)"
        )
    per = n // count
    return index * per, (index + 1) * per


def _process_allgather(local: np.ndarray) -> np.ndarray:
    """``torch.distributed.all_gather`` of each process's equally shaped
    host array, concatenated in rank order (the process group must take CPU
    tensors, as the gloo group of ``compat.maybe_init_distributed`` does)."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(local))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=0).numpy()


def allgather_hosts(local, count: int | None = None, gather=None):
    """Concatenate each process's leading-axis slice back into the full axis.

    The inverse of :func:`host_bounds` partitioning: every process
    contributes its local results and receives the concatenation in rank
    order.  At ``process_count() == 1`` this is the identity.  ``gather``
    injects a replacement for the process group's all-gather in tests.
    """
    if count is None:
        count = compat.process_count()
    if count == 1:
        return np.asarray(local)
    if gather is None:
        gather = _process_allgather
    return np.asarray(gather(np.asarray(local)))


# ---------------------------------------------------------------------------
# Sample-axis sharding: full-window simulation
# ---------------------------------------------------------------------------


def run_int_sharded(
    net, qparams, spikes_in, mesh, backend: str | InferenceBackend = "reference"
) -> SimRecord:
    """``run_int`` with the sample axis spread across a device mesh.

    Bit-exact with the serial backend run: per-sample dynamics are
    independent, each shard runs the identical int32 program on its slice,
    and reassembly is concatenation.  A ragged batch is zero-padded up to
    the shard multiple and sliced back.  ``mesh`` resolving to one device
    (or ``None``) runs the serial backend directly.

    A ``jit_compatible = False`` backend is asked for a ``jit_surrogate``
    before the partition is abandoned (JAX's rule): ``backend="event"``
    (auto / gather) shards through the fixed-capacity pallas strategy, with
    its budget measured once from the whole raster before the split, so
    every shard runs one budget.  Only a backend with no surrogate (an
    explicit ``EventBackend("csr")``) runs serially -- with a
    ``UserWarning``, and only when a real multi-shard partition is given up.
    """
    dmesh = resolve_mesh(mesh)
    resolved = get_backend(backend)
    spikes = torch.as_tensor(spikes_in)
    if _serial(dmesh):
        return resolved.run_int(net, list(qparams), spikes)
    if not resolved.jit_compatible:
        surrogate = resolved.jit_surrogate(net, spikes)
        if surrogate is None:
            warnings.warn(
                f"backend {resolved.name!r} is not jit-compatible and offers no "
                f"jit surrogate; mesh ignored ({dmesh.n_shards} shards abandoned "
                "for the serial path). The event backend's strategy='pallas' "
                "shards; strategy='csr' is host-side by design.",
                UserWarning,
                stacklevel=2,
            )
            return resolved.run_int(net, list(qparams), spikes)
        resolved = surrogate
    B = spikes.shape[1]
    shards = split(pad_to_shards(spikes, dmesh, axis=1), dmesh, axis=1)
    recs = [
        resolved.run_int(net, qp, s) for qp, s in zip(replicate(qparams, dmesh), shards)
    ]
    return _join_records(recs, shards, dmesh, B)


def run_float_sharded(
    net, params, spikes_in, spike_fn, mesh, backend: str | InferenceBackend = "reference"
) -> SimRecord:
    """``run_float`` with the sample axis spread across a device mesh.

    Same contract as :func:`run_int_sharded`.  Each sample's float
    trajectory is independent of the others, but a float product over B/n
    rows may sum in another order than over B (oneDNN and cuBLAS pick their
    blocking by shape), so a shard's bits can differ from the serial run's
    in the last place.
    """
    dmesh = resolve_mesh(mesh)
    resolved = get_backend(backend)
    spikes = torch.as_tensor(spikes_in)
    if _serial(dmesh):
        return resolved.run_float(net, list(params), spikes, spike_fn)
    B = spikes.shape[1]
    shards = split(pad_to_shards(spikes, dmesh, axis=1), dmesh, axis=1)
    recs = [
        resolved.run_float(net, p, s, spike_fn) for p, s in zip(replicate(params, dmesh), shards)
    ]
    return _join_records(recs, shards, dmesh, B)


# ---------------------------------------------------------------------------
# Candidate-axis sharding: the population DSE fan-out
# ---------------------------------------------------------------------------


def run_int_population_sharded(
    net, stacked_qparams, beta_regs, alpha_regs, spikes_in, mesh,
    return_events: bool = False,
):
    """``run_int_population`` with the *candidate* axis spread across devices.

    Each shard scores its slice of the population through the same sweep
    (on the card: one ``spike_matmul`` per layer, one ``lif_scan`` per
    feed-forward IF/LIF layer and one ``ataf_scan`` per ATA-F IF/LIF layer
    for the slice), so per-candidate results are
    bit-exact with the one-device sweep and with serial ``eval_int``.  A
    population that does not divide by the shard count is padded by
    repeating the last candidate -- its parameters, theta and decay
    registers -- and the padding is sliced off on return.  The shared
    raster is copied to each distinct device once.
    """
    dmesh = resolve_mesh(mesh)
    if _serial(dmesh):
        return run_int_population(
            net, list(stacked_qparams), beta_regs, alpha_regs, spikes_in, return_events
        )
    n_cand = beta_regs.shape[0]
    edge = lambda t: split(pad_to_shards(t, dmesh, axis=0, mode="edge"), dmesh, axis=0)
    per_layer = [[edge(t) for t in p] for p in stacked_qparams]  # [layer][leaf][shard]
    betas, alphas = edge(beta_regs), edge(alpha_regs)
    spikes = torch.as_tensor(spikes_in)
    raster = {dev: spikes.to(dev) for dev in dict.fromkeys(dmesh.devices)}
    counts, emitted = [], []
    for i, dev in enumerate(dmesh.devices):
        stacked = [type(p)(*(leaf[i] for leaf in leaves)) for p, leaves in zip(stacked_qparams, per_layer)]
        c, e = run_int_population(net, stacked, betas[i], alphas[i], raster[dev], return_events=True)
        counts.append(c)
        emitted.append(e)
    counts = join(counts, dmesh, 0)[:n_cand]
    if return_events:
        return counts, join(emitted, dmesh, 0)[:n_cand]
    return counts


# ---------------------------------------------------------------------------
# Sample-axis sharding: the ragged batched runner (serving's whole-window form)
# ---------------------------------------------------------------------------


def run_int_batched_sharded(net, qparams, rasters, lengths, mesh) -> SimRecord:
    """Sharded form of ``backend.run_int_batched`` (callers pass ``mesh=``
    there; this is the implementation it dispatches to).

    Pads the sample axis with zero rasters of length 0 -- the validity mask
    zeroes every contribution of a length-0 lane, so padding is inert --
    and slices the reassembled record back to the true batch.
    """
    dmesh = resolve_mesh(mesh)
    rasters = torch.as_tensor(rasters)
    T, B, _ = rasters.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32)
    else:
        lengths = torch.as_tensor(lengths).to(torch.int32)
        if tuple(lengths.shape) != (B,):
            raise ValueError(f"lengths must be [B]={B}, got {tuple(lengths.shape)}")
    if _serial(dmesh):
        return run_int_batched(net, qparams, rasters, lengths)
    rs = split(pad_to_shards(rasters, dmesh, axis=1), dmesh, axis=1)
    ls = split(pad_to_shards(lengths, dmesh, axis=0), dmesh, axis=0)  # zero length = inert lane
    recs = [
        run_int_batched(net, qp, r, l) for qp, r, l in zip(replicate(qparams, dmesh), rs, ls)
    ]
    return _join_records(recs, rs, dmesh, B)


# ---------------------------------------------------------------------------
# Lane-axis sharding: the serving engine's per-shard lane pools
# ---------------------------------------------------------------------------


def wrap_lane_window(fn, dmesh: DeviceMesh):
    """Partition a lane-pool window function across a device mesh.

    ``fn(qparams, states, x_chunk, lane_meta, *args) -> (states, packed)``
    is the serving engine's whole-pool chunk advance.  The wrapper returned
    takes ``(replicas, pools, x_chunk, lane_meta, *args)``: ``replicas`` is
    :func:`replicate`'s per-shard parameter list, ``pools`` one lane pool
    per shard (``n_lanes / n_shards`` lanes on the shard's device; the
    index *is* the placement: lane ``s`` lives in pool ``s // (n_lanes /
    n_shards)``), and ``x_chunk`` [k, n_lanes, n_in] and ``lane_meta`` [2,
    n_lanes] are split on axis 1, each shard's slice made contiguous and
    placed on its device; ``args`` (per-call options) go to every shard
    as they are.  ``fn`` runs per shard on that shard's pool; the packed
    outputs are concatenated on axis 1 on the mesh's first device.
    Returns ``(pools, packed)``.  Lanes never interact, so a sharded pool
    is bit-exact with the unsharded pool.
    """

    def sharded(replicas, pools, x_chunk, lane_meta, *args):
        xs = split(x_chunk, dmesh, axis=1)
        metas = split(lane_meta, dmesh, axis=1)
        packed = []
        for i in range(dmesh.n_shards):
            pools[i], out = fn(replicas[i], pools[i], xs[i], metas[i], *args)
            packed.append(out)
        return pools, join(packed, dmesh, axis=1)

    return sharded
