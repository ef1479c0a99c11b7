"""Pluggable inference backends for the Flexi-NeurA simulator (PyTorch port).

Port of ``repro/core/backend.py``.  Three backends, each bit-identical to
``reference``:

``reference``
    Step-major simulation: a loop over time steps, each step walking every
    core via ``int_layer_step``.  The numerics contract.  Its ``run_float``
    is the differentiable simulation BPTT trains through (``fused`` and
    ``event`` delegate to it, as in JAX).

``fused``
    Layer-major traversal: each feed-forward IF/LIF core's whole window runs
    as one exact int32 product (``spike_integrate`` -> ``spike_matmul``)
    feeding the membrane scan (``lif_scan``); other cores run the step loop.

``event``
    Layer-major event-driven traversal: per layer, only the active
    pre-synaptic rows are accumulated.  Strategies ``"gather"`` (AER
    encoder + ``sparse_accum`` at a measured budget), ``"csr"`` (host scipy),
    ``"pallas"`` (the fixed-capacity path of ``sparse_accum_currents``, name
    kept from the JAX API) and ``"auto"`` (``gather`` on the card, ``csr``
    on the CPU -- the JAX rule with "on the TPU" read as "on the card").  A
    layer too dense for the sparse path falls back to the dense window.

Kernel choice follows the tensors: the wrappers in ``repro_torch.kernels``
launch their CUDA kernel for tensors on the card and run their plain version
on the CPU.  On the card every exact int32 product goes through
``spike_matmul`` or ``sparse_accum``; the only float products are the
certified f32 lowerings (``exact_f32_matmul``), which refuse to run under
TF32.

The serving seams -- ``batched_lane_init`` / ``batched_lane_window`` /
``batched_lane_tick``, ``lane_state_take`` / ``lane_states_take`` /
``lane_state_put`` and
``run_int_batched`` -- advance pools of independent sample lanes; each lane
is bit-exact with a serial single-sample ``run_int``.

The population sweep of the Flex-plorer DSE (``stack_population`` /
``run_int_population``) scores P precision candidates -- one static network
structure, different quantized weights, thresholds and CG decay registers --
at once.  JAX vmaps a step-major program over the candidates; here every
tensor carries an explicit candidate axis and the traversal is layer-major,
as in ``fused``: each layer's feed-forward currents for the whole window are
one ``spike_matmul`` launch over all candidates, a feed-forward IF/LIF
layer's phase B is one ``lif_scan`` launch with per-candidate theta and
decay registers read on the device, an ATA-F IF/LIF layer's is one
``ataf_scan`` launch (the same, with each candidate's self-weight), and every
other layer runs the step loop with the candidate axis carried through.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.fixed_point import exact_f32_matmul, int_max
from repro_torch.core.snn_layer import (
    IntLayerParams,
    LayerState,
    NeuronModel,
    ResetMode,
    Topology,
    fused_eligible,
    _scan_currents,
    _traced_decays,
    float_layer_init,
    float_layer_step,
    int_layer_init,
    int_layer_step,
    int_layer_step_dynamic,
    int_layer_window,
    int_layer_window_carry,
    int_layer_window_from_currents,
)
from repro_torch.kernels import work
from repro_torch.kernels.lif_scan.lif_scan import ataf_scan, lif_scan
from repro_torch.kernels.quant_matmul.spike_matmul import spike_integrate, spike_matmul
from repro_torch.kernels.sparse_accum.ops import fixed_capacity_events, sparse_accum_currents
from repro_torch.kernels.sparse_accum.sparse_accum import sparse_accum

__all__ = [
    "SimRecord",
    "InferenceBackend",
    "ReferenceBackend",
    "FusedBackend",
    "EventBackend",
    "register_backend",
    "get_backend",
    "available_backends",
    "batched_lane_init",
    "batched_lane_window",
    "batched_lane_tick",
    "lane_state_take",
    "lane_states_take",
    "lane_state_put",
    "run_int_batched",
    "check_population_structure",
    "stack_population",
    "run_int_population",
]


def _count(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """int32 sum (torch's default integer sum is int64; jnp's keeps int32)."""
    return x.sum(dim=dim, dtype=torch.int32)


def _batch_mean(x: torch.Tensor) -> np.ndarray:
    """float32 mean over the batch axis of an integer [T, batch] count.

    Bit-equal to ``jnp.mean`` on the reference's XLA build: the integer sum
    is exact, and XLA turns the division by the constant batch size into a
    multiplication by its float32 reciprocal, so the mean is
    ``sum * fl32(1 / batch)`` -- not the correctly rounded quotient, which
    differs in the last ulp for some counts.
    """
    total = x.sum(dim=1, dtype=torch.int64).to(torch.float32)
    return (total * (np.float32(1) / np.float32(x.shape[1]))).cpu().numpy()


@dataclasses.dataclass
class SimRecord:
    """Outputs of a full-window simulation.

    spike_counts -- [batch, n_classes] output-layer spike totals (rate code)
    layer_spikes -- list over layers of [T, batch] per-step spike totals
                    (events *emitted* by that layer)
    input_events -- [T, batch] per-step active input channels into layer 0
    """

    spike_counts: torch.Tensor
    layer_spikes: list[torch.Tensor]
    input_events: torch.Tensor | None = None

    def predictions(self) -> torch.Tensor:
        return torch.argmax(self.spike_counts, dim=-1)

    def event_stats(self) -> dict:
        """Batch-mean event traffic as numpy float32: the latency/energy model's inputs."""
        if self.input_events is None:
            raise ValueError("record carries no input_events (legacy record?)")
        return {
            "input_events_per_step": _batch_mean(self.input_events),
            "layer_events_per_step": [_batch_mean(s) for s in self.layer_spikes],
        }


def _run_step_major(
    net, params, spikes_in, init_fn=int_layer_init, step_fn=int_layer_step
) -> SimRecord:
    """Step-major simulation: loop over time, walk the cores inside.  The
    integer datapath by default; ``float_layer_init`` and a float step give
    the differentiable simulation (float32 spike totals)."""
    batch = spikes_in.shape[1]
    states = [init_fn(cfg, batch, device=spikes_in.device) for cfg in net.layers]
    total = (lambda x, dim=-1: x.sum(dim=dim)) if spikes_in.is_floating_point() else _count
    out_spikes, emitted = [], [[] for _ in net.layers]
    for s_t in spikes_in:
        x = s_t
        for li, (cfg, p) in enumerate(zip(net.layers, params)):
            states[li], x = step_fn(cfg, p, states[li], x)
            emitted[li].append(total(x))
        out_spikes.append(x)
    counts = total(torch.stack(out_spikes), dim=0)
    return SimRecord(
        spike_counts=counts,
        layer_spikes=[torch.stack(e) for e in emitted],
        input_events=_count(spikes_in != 0),
    )


class InferenceBackend:
    """One execution strategy for a full-window network simulation."""

    name = "base"
    #: Kept from the JAX API (there it says whether ``run_int`` may be traced
    #: under an outer ``jax.jit``).  PyTorch runs eagerly, so nothing in the
    #: port branches on it.
    jit_compatible = True

    def run_int(self, net, qparams: Sequence[IntLayerParams], spikes_in) -> SimRecord:
        raise NotImplementedError

    def run_float(self, net, params, spikes_in, spike_fn) -> SimRecord:
        raise NotImplementedError

    def jit_surrogate(self, net, spikes_in) -> "InferenceBackend | None":
        """A fixed-capacity stand-in carrying this backend's numerics, or None."""
        return None


class ReferenceBackend(InferenceBackend):
    """Step-major semantics -- the numerics contract for every backend."""

    name = "reference"

    # No configuration knobs: any two instances are interchangeable, so
    # compare and hash by value.
    def __eq__(self, other) -> bool:
        return type(other) is type(self)

    def __hash__(self) -> int:
        return hash((type(self).__module__, type(self).__qualname__))

    def run_int(self, net, qparams, spikes_in) -> SimRecord:
        return _run_step_major(net, list(qparams), spikes_in.to(torch.int32))

    def run_float(self, net, params, spikes_in, spike_fn) -> SimRecord:
        def step(cfg, p, st, x):
            return float_layer_step(cfg, p, st, x, spike_fn)

        return _run_step_major(
            net, list(params), spikes_in.to(torch.float32), float_layer_init, step
        )


class FusedBackend(InferenceBackend):
    """Layer-major traversal through the fused integration + membrane kernels.

    Each feed-forward IF/LIF core runs ``spike_integrate`` then ``lif_scan``;
    on the card those launch the ``spike_matmul`` and ``lif_scan`` CUDA
    kernels (theta is read by the kernel on the device, with no host sync), on
    the CPU their plain versions.  Other cores run the step loop.
    """

    name = "fused"

    def _fused_layer_window(self, cfg, p: IntLayerParams, raster):
        currents = spike_integrate(raster, p.w_ff)
        code = cfg.beta_code()
        spikes, _ = lif_scan(
            currents,
            theta_q=p.theta_q,
            decay_k=256 if code.bypass else code.k,
            u_bits=cfg.u_bits,
            reset_to_zero=cfg.reset == ResetMode.ZERO,
        )
        return spikes

    def run_int(self, net, qparams, spikes_in) -> SimRecord:
        x = spikes_in.to(torch.int32)
        input_events = _count(x != 0)
        emitted = []
        for cfg, p in zip(net.layers, qparams):
            if fused_eligible(cfg):
                x = self._fused_layer_window(cfg, p, x)
            else:
                x = int_layer_window(cfg, p, x)
            emitted.append(_count(x))  # [T, batch]
        return SimRecord(
            spike_counts=_count(x, dim=0), layer_spikes=emitted, input_events=input_events
        )

    def run_float(self, net, params, spikes_in, spike_fn) -> SimRecord:
        # The fused kernels are integer-only; float (training) simulation
        # keeps the differentiable reference semantics.
        return ReferenceBackend().run_float(net, params, spikes_in, spike_fn)


# ---------------------------------------------------------------------------
# Event-driven backend: work scales with spike counts, not dense layer size
# ---------------------------------------------------------------------------

try:  # the host CSR strategy wants scipy's C sparse kernels; optional
    import scipy.sparse as _scipy_sparse
except ImportError:  # pragma: no cover
    _scipy_sparse = None


def _round_capacity(k: int, multiple: int = 16) -> int:
    """Round an event budget up to a lane-aligned multiple."""
    return max(multiple, ((k + multiple - 1) // multiple) * multiple)


def _max_active(x: torch.Tensor) -> int:
    """Max active channels in any (t, b) row (a host value: one sync)."""
    return int(_count(x != 0).max()) if x.numel() else 0


def _gather_currents(raster, w_ff, k_active: int):
    """Sparse FF integration: the AER encoder compacts each row's active
    channels into ``k_active`` slots and ``sparse_accum`` sums only those
    weight rows -- the JAX ``"ek,eko->eo"`` contraction, on the card in the
    CUDA kernel."""
    T, B, n_in = raster.shape
    flat = raster.reshape(T * B, n_in)
    vals, idx = fixed_capacity_events(flat, k_active)
    return sparse_accum(vals, idx, w_ff.contiguous()).reshape(T, B, -1)


def _csr_currents(
    raster: np.ndarray, w_ff: np.ndarray, active: np.ndarray, row_counts: np.ndarray
) -> np.ndarray:
    """Host-side sparse FF integration through scipy's C CSR kernel (exact
    int32, the dense product's wraparound semantics)."""
    T, B, n_in = raster.shape
    rows = T * B
    nz = np.flatnonzero(active)
    c = (nz % n_in).astype(np.int32)
    data = np.ascontiguousarray(raster).reshape(-1)[nz].astype(np.int32, copy=False)
    indptr = np.zeros(rows + 1, np.int64)
    np.cumsum(row_counts.reshape(-1), out=indptr[1:])
    mat = _scipy_sparse.csr_matrix((data, c, indptr), shape=(rows, n_in))
    currents = np.asarray(mat @ w_ff.astype(np.int32, copy=False), np.int32)
    return currents.reshape(T, B, -1)


def _dense_layer_window(cfg, params: IntLayerParams, raster):
    """Density fallback: one flat exact product feeding the step scan."""
    return int_layer_window_from_currents(cfg, params, spike_integrate(raster, params.w_ff))


def _fixed_layer_window(cfg, params: IntLayerParams, raster, budget, f32_exact, use_pallas):
    """One layer's window through the fixed-capacity sparse accumulate.

    ``budget`` None is the density fallback (dense integration at the same
    lowering choices); ``f32_exact`` certifies the f32 GEMM's exactness.
    """
    if budget is None:
        if f32_exact:
            currents = _ff_currents_f32_exact(raster, params.w_ff)
        else:
            currents = spike_integrate(raster, params.w_ff)
    else:
        currents = sparse_accum_currents(
            raster, params.w_ff, budget, f32_exact=f32_exact, use_pallas=use_pallas
        )
    return int_layer_window_from_currents(cfg, params, currents)


class EventBackend(InferenceBackend):
    """Event-driven layer-major traversal: integrate active rows, skip silence.

    ``event_budget`` pins the layer-0 event budget (a capacity contract:
    callers guarantee no row carries more active channels); unset, runs
    measure it per layer.  ``input_max_val`` bounds input values for the
    same declared path (``jit_surrogate``); eager runs measure it.  A layer
    whose budget exceeds ``dense_threshold * n_in`` runs the dense window.
    ``use_pallas`` (JAX name) forces the event-list kernel route of the
    ``pallas`` strategy on or off; ``None`` takes it when the raster lies on
    the card.  Bit-exact to ``reference`` on every neuron model x topology x
    reset mode.
    """

    name = "event"
    jit_compatible = False  # class default; pallas instances override below

    def __init__(
        self,
        strategy: str = "auto",
        dense_threshold: float = 0.34,
        capacity_multiple: int = 16,
        event_budget: int | None = None,
        input_max_val: int = 1,
        use_pallas: bool | None = None,
    ):
        if strategy not in ("auto", "gather", "csr", "pallas"):
            raise ValueError(f"unknown event strategy {strategy!r}")
        if strategy == "csr" and _scipy_sparse is None:
            raise ValueError("event strategy 'csr' needs scipy installed")
        if not 0.0 < dense_threshold <= 1.0:
            raise ValueError(f"dense_threshold must be in (0, 1], got {dense_threshold}")
        if not isinstance(capacity_multiple, int) or capacity_multiple < 1:
            raise ValueError(f"capacity_multiple must be a positive int, got {capacity_multiple}")
        if event_budget is not None and (not isinstance(event_budget, int) or event_budget < 1):
            raise ValueError(f"event_budget must be a positive int or None, got {event_budget}")
        if not isinstance(input_max_val, int) or input_max_val < 1:
            raise ValueError(f"input_max_val must be a positive int, got {input_max_val}")
        self.strategy = strategy
        self.dense_threshold = dense_threshold
        self.capacity_multiple = capacity_multiple
        self.event_budget = event_budget
        self.input_max_val = input_max_val
        self.use_pallas = use_pallas
        self.jit_compatible = strategy == "pallas"

    def _static_key(self):
        return (
            self.strategy,
            self.dense_threshold,
            self.capacity_multiple,
            self.event_budget,
            self.input_max_val,
            self.use_pallas,
        )

    def __eq__(self, other):
        return isinstance(other, EventBackend) and self._static_key() == other._static_key()

    def __hash__(self):
        return hash(self._static_key())

    def resolved_strategy(self, device: str | torch.device = "cuda") -> str:
        """The concrete strategy for data on ``device``: ``auto`` is
        ``gather`` on the card (or without scipy) and ``csr`` on the CPU."""
        if self.strategy != "auto":
            return self.strategy
        if torch.device(device).type == "cuda" or _scipy_sparse is None:
            return "gather"
        return "csr"

    def _budget(self, x_counts_max: int, cfg) -> int:
        return min(cfg.n_in, _round_capacity(x_counts_max, self.capacity_multiple))

    def static_budget(self, n_in: int, k_max: int | None = None) -> int:
        """The lane-rounded event budget for a layer of width ``n_in``:
        the configured ``event_budget``, else the measured ``k_max``, else
        full capacity."""
        if self.event_budget is not None:
            k = self.event_budget
        elif k_max is not None:
            k = k_max
        else:
            return n_in
        return min(n_in, _round_capacity(k, self.capacity_multiple))

    def serve_budget(self, n_in: int, admission_threshold: float) -> int:
        """The event budget a serving engine runs its sparse lane route at:
        the configured ``event_budget``, else 2x the admission density
        (lane-rounded)."""
        if self.event_budget is not None:
            return self.static_budget(n_in)
        k = max(1, int(2 * admission_threshold * n_in))
        return min(n_in, _round_capacity(k, self.capacity_multiple))

    def _f32_certified(self, cfg, budget: int | None, max_val: int) -> bool:
        """True when the budget bound certifies the exact-f32 lowering."""
        rows = cfg.n_in if budget is None else min(budget, cfg.n_in)
        return int_max(cfg.w_bits) * rows * max_val < 2**24

    def run_int(self, net, qparams, spikes_in) -> SimRecord:
        x = torch.as_tensor(spikes_in).to(torch.int32)
        strategy = self.resolved_strategy(x.device)
        if strategy == "csr":
            return self._run_int_csr(net, qparams, x)
        if strategy == "pallas":
            return self._run_int_fixed(net, qparams, x)
        input_events = _count(x != 0)
        emitted = []
        for cfg, p in zip(net.layers, qparams):
            k = self._budget(_max_active(x), cfg)
            if k > self.dense_threshold * cfg.n_in:
                x = _dense_layer_window(cfg, p, x)
            else:
                x = int_layer_window_from_currents(cfg, p, _gather_currents(x, p.w_ff, k))
            emitted.append(_count(x))  # [T, batch]
        return SimRecord(
            spike_counts=_count(x, dim=0), layer_spikes=emitted, input_events=input_events
        )

    def _run_int_fixed(self, net, qparams, x) -> SimRecord:
        """The fixed-capacity (pallas-strategy) traversal: per layer, the
        measured budget and input magnitude pick the lowering."""
        input_events = _count(x != 0)
        emitted = []
        max_val = max(1, int(x.max())) if x.numel() else 1
        for cfg, p in zip(net.layers, qparams):
            budget = self.static_budget(cfg.n_in, k_max=_max_active(x))
            if budget > self.dense_threshold * cfg.n_in:
                budget = None  # density fallback: dense lowering, same numerics
            f32_ok = self._f32_certified(cfg, budget, max_val)
            x = _fixed_layer_window(cfg, p, x, budget, f32_ok, self.use_pallas)
            emitted.append(_count(x))  # [T, batch]
            max_val = 1  # phase B emits {0,1}
        return SimRecord(
            spike_counts=_count(x, dim=0), layer_spikes=emitted, input_events=input_events
        )

    def jit_surrogate(self, net, spikes_in) -> "EventBackend | None":
        """A pallas-strategy twin with the layer-0 budget and input magnitude
        measured from ``spikes_in`` (None for an explicit ``csr``)."""
        if self.strategy == "csr":
            return None
        x = torch.as_tensor(spikes_in)
        budget = self.event_budget
        if budget is None:
            budget = max(1, _max_active(x))
        input_max_val = max(self.input_max_val, int(x.max()) if x.numel() else 0)
        return EventBackend(
            strategy="pallas",
            dense_threshold=self.dense_threshold,
            capacity_multiple=self.capacity_multiple,
            event_budget=budget,
            input_max_val=input_max_val,
            use_pallas=self.use_pallas,
        )

    def _run_int_csr(self, net, qparams, x: torch.Tensor) -> SimRecord:
        """Host-driven traversal: numpy event bookkeeping and scipy CSR
        integration; phase B runs on the parameters' device."""
        device = x.device
        xn = x.cpu().numpy()
        active = xn != 0
        counts = active.sum(axis=-1, dtype=np.int32)  # [T, batch]
        input_events = counts
        emitted = []
        for cfg, p in zip(net.layers, qparams):
            k = self._budget(int(counts.max(initial=0)), cfg)
            if k > self.dense_threshold * cfg.n_in:
                xn = _dense_layer_window(cfg, p, torch.from_numpy(xn).to(device)).cpu().numpy()
                active = xn != 0
                counts = active.sum(axis=-1, dtype=np.int32)
            else:
                currents = _csr_currents(xn, p.w_ff.cpu().numpy(), active, counts)
                xn = int_layer_window_from_currents(
                    cfg, p, torch.from_numpy(currents).to(device)
                ).cpu().numpy()
                # phase B emits {0,1}: the raster is its own mask and its sum
                # doubles as the next layer's event count
                active = xn
                counts = xn.sum(axis=-1, dtype=np.int32)
            emitted.append(counts)
        return SimRecord(
            spike_counts=torch.from_numpy(xn.sum(axis=0, dtype=np.int32)).to(device),
            layer_spikes=[torch.from_numpy(e).to(device) for e in emitted],
            input_events=torch.from_numpy(input_events).to(device),
        )

    def run_float(self, net, params, spikes_in, spike_fn) -> SimRecord:
        # Float (training) simulation keeps the differentiable reference
        # semantics; sparsity games don't pay off under surrogate gradients.
        return ReferenceBackend().run_float(net, params, spikes_in, spike_fn)


_REGISTRY: dict[str, Callable[[], InferenceBackend]] = {}


def register_backend(name: str, factory: Callable[[], InferenceBackend]) -> None:
    """Register a backend factory under ``name`` (later wins, like a config)."""
    _REGISTRY[name] = factory


def get_backend(backend: str | InferenceBackend) -> InferenceBackend:
    """Resolve a backend selector: a registered name or an instance."""
    if isinstance(backend, InferenceBackend):
        return backend
    try:
        return _REGISTRY[backend]()
    except KeyError:
        raise ValueError(
            f"unknown inference backend {backend!r}; available: {available_backends()}"
        ) from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


register_backend("reference", ReferenceBackend)
register_backend("fused", FusedBackend)
register_backend("event", EventBackend)


# ---------------------------------------------------------------------------
# Population-batched integer simulation (the Flex-plorer DSE hot path)
# ---------------------------------------------------------------------------


# Layer fields a population sweep may vary per candidate: they only reach the
# sweep through quantized values / decay registers.  Everything else is
# static (shared by the whole sweep) and must match the base net.
_POPULATION_KNOBS = ("w_bits", "w_rec_bits", "leak_bits", "beta", "alpha")


def check_population_structure(base, nets) -> None:
    """Raise unless every candidate shares ``base``'s static structure (the
    span ``population.check``)."""
    with work.span("population.check"):
        base_sig = [
            {f.name: getattr(lc, f.name) for f in dataclasses.fields(lc) if f.name not in _POPULATION_KNOBS}
            for lc in base.layers
        ]
        for net in nets:
            if len(net.layers) != len(base.layers):
                raise ValueError(
                    f"population candidate {net.name!r} has {len(net.layers)} layers, base has {len(base.layers)}"
                )
            for i, lc in enumerate(net.layers):
                for name, want in base_sig[i].items():
                    got = getattr(lc, name)
                    if got != want:
                        raise ValueError(
                            f"population candidate {net.name!r} layer {i} differs from the "
                            f"base net in static field {name!r} ({got!r} != {want!r}); only "
                            f"{_POPULATION_KNOBS} may vary across a population sweep"
                        )


def stack_population(nets, qparams_list):
    """Stack per-candidate quantized parameters for one population sweep.

    ``nets`` are per-candidate :class:`NetworkConfig`s sharing one static
    structure; ``qparams_list`` the matching ``quantize_params`` outputs.
    Returns ``(stacked_qparams, beta_regs, alpha_regs)``: each stacked leaf
    gains a leading candidate axis, and the decay registers are int32 ``[P,
    n_layers]`` packed DecayRate values on the parameters' device (the span
    ``population.stack``).
    """
    with work.span("population.stack"):
        n_layers = len(nets[0].layers)
        device = qparams_list[0][0].w_ff.device
        stacked = [
            IntLayerParams(
                w_ff=torch.stack([qp[l].w_ff for qp in qparams_list]),
                w_rec=torch.stack([qp[l].w_rec for qp in qparams_list]),
                theta_q=torch.stack([qp[l].theta_q for qp in qparams_list]),
            )
            for l in range(n_layers)
        ]
        beta_regs = torch.tensor(
            [[cfg.beta_code().decay_rate_register for cfg in net.layers] for net in nets],
            dtype=torch.int32,
        ).to(device)
        alpha_regs = torch.tensor(
            [[cfg.alpha_code().decay_rate_register for cfg in net.layers] for net in nets],
            dtype=torch.int32,
        ).to(device)
        return stacked, beta_regs, alpha_regs


def _per_candidate(p: IntLayerParams) -> IntLayerParams:
    """A stacked layer's parameters shaped to broadcast against state [P,
    batch, n_out]: theta and an ATA-F self-weight as [P, 1, 1]."""
    col = lambda t: t.reshape(-1, 1, 1)
    w_rec = col(p.w_rec) if p.w_rec.dim() == 1 else p.w_rec
    return IntLayerParams(w_ff=p.w_ff, w_rec=w_rec, theta_q=col(p.theta_q))


def _run_int_dynamic(net, stacked_qparams, beta_regs, alpha_regs, spikes_in):
    """Step-major run of P candidates with traced decay registers: JAX's
    ``_run_int_dynamic`` (one candidate, vmapped there) with the candidate
    axis explicit, through :func:`int_layer_step_dynamic`.  The plain
    version that :func:`run_int_population` computes layer-major.  Returns
    ``(spike_counts [P, batch, n_classes], emitted [P, T, n_layers, batch])``.
    """
    P, B = beta_regs.shape[0], spikes_in.shape[1]
    params = [_per_candidate(p) for p in stacked_qparams]
    z = lambda cfg: torch.zeros(P, B, cfg.n_out, dtype=torch.int32, device=beta_regs.device)
    states = [LayerState(z(cfg), z(cfg), z(cfg)) for cfg in net.layers]
    regs = lambda r, i: r[:, i].reshape(P, 1, 1)
    out_spikes, emitted = [], []
    for s_t in spikes_in.to(torch.int32):
        x, step_emitted = s_t, []
        for i, (cfg, p) in enumerate(zip(net.layers, params)):
            states[i], x = int_layer_step_dynamic(
                cfg, p, states[i], x, regs(beta_regs, i), regs(alpha_regs, i)
            )
            step_emitted.append(_count(x))  # [P, batch]
        out_spikes.append(x)
        emitted.append(torch.stack(step_emitted, dim=1))  # [P, n_layers, batch]
    counts = _count(torch.stack(out_spikes, dim=1), dim=1)
    return counts, torch.stack(emitted, dim=1)


def _population_currents(x, w_ff):
    """Feed-forward currents [P, T, batch, n_out] of every candidate: ``x`` is
    the shared raster [T, batch, n_in] (layer 0) or the candidates' own
    [P, T, batch, n_in]; one ``spike_matmul`` launch either way."""
    T, B, K = x.shape[-3:]
    P = w_ff.shape[0]
    s = x.reshape(*x.shape[:-3], T * B, K).contiguous()
    return spike_matmul(s, w_ff.contiguous()).reshape(P, T, B, -1)


def _population_window(cfg, p: IntLayerParams, currents, beta_reg, alpha_reg):
    """Spikes [P, T, batch, n_out] of one layer of every candidate from its
    currents: ``lif_scan`` (one launch) for a feed-forward IF/LIF core,
    ``ataf_scan`` (one launch) for an ATA-F IF/LIF core, else the step loop
    over the window with the candidate axis carried through (ATA-T's
    per-step recurrence products through ``spike_matmul``, Synaptic's
    current), inside the span ``population.step_loop``."""
    scan = dict(
        theta_q=p.theta_q,
        decay_k=beta_reg,
        u_bits=cfg.u_bits,
        reset_to_zero=cfg.reset == ResetMode.ZERO,
    )
    if fused_eligible(cfg):
        spikes, _ = lif_scan(currents, **scan)
        return spikes
    if cfg.topology == Topology.ATA_F and cfg.neuron in (NeuronModel.IF, NeuronModel.LIF):
        return ataf_scan(currents, w_self=p.w_rec.reshape(-1), **scan)
    with work.span("population.step_loop"):
        P, T, B, N = currents.shape
        col = lambda t: t.reshape(P, 1, 1)  # broadcast a per-candidate scalar over [P, B, N]
        z = lambda: torch.zeros(P, B, N, dtype=torch.int32, device=currents.device)
        state = LayerState(u=z(), i_syn=z(), prev_spk=z())
        decays = _traced_decays(col(beta_reg), col(alpha_reg))
        _, spikes = _scan_currents(cfg, _per_candidate(p), state, currents.transpose(0, 1), decays)
        return spikes.transpose(0, 1).contiguous()  # [T, P, B, N] -> [P, T, B, N]


def run_int_population(
    net, stacked_qparams, beta_regs, alpha_regs, spikes_in, return_events: bool = False
):
    """Score P precision candidates in one sweep.

    ``spikes_in`` int [T, batch, n_in] is shared by all candidates (the DSE
    evaluates every candidate on the same held-out batch).  Returns int32
    spike counts [P, batch, n_classes]; with ``return_events``, also the
    per-candidate emitted event totals [P, T, n_layers, batch] (each
    candidate quantizes differently, so its event traffic -- and therefore
    its modeled latency/energy -- differs too).  Bit-identical to the
    step-major :func:`_run_int_dynamic` (JAX's vmapped program): integer
    addition is associative and ``_integrate_acc`` saturates once per step,
    after the sum, so currents computed for the whole window first give the
    same state.

    Launches per data batch on the card: one ``spike_matmul`` per layer, one
    ``lif_scan`` per feed-forward IF/LIF layer, one ``ataf_scan`` per ATA-F
    IF/LIF layer, and T more ``spike_matmul`` per ATA-T layer (its
    recurrence needs the previous step's spikes) -- none of it per
    candidate.  ATA-T and Synaptic layers step their phase B in PyTorch.
    """
    x = torch.as_tensor(spikes_in).to(device=beta_regs.device, dtype=torch.int32)
    emitted = []
    for li, (cfg, p) in enumerate(zip(net.layers, stacked_qparams)):
        currents = _population_currents(x, p.w_ff)
        x = _population_window(cfg, p, currents, beta_regs[:, li], alpha_regs[:, li])
        emitted.append(_count(x))  # [P, T, batch]
    counts = _count(x, dim=1)  # [P, batch, n_classes]
    if return_events:
        return counts, torch.stack(emitted, dim=2)  # [P, T, n_layers, batch]
    return counts


# ---------------------------------------------------------------------------
# Batched lane stepping (the SNN serving engine's hot path)
# ---------------------------------------------------------------------------


def batched_lane_init(net, n_lanes: int, device: str | torch.device = "cuda") -> list:
    """Fresh per-layer states for a pool of ``n_lanes`` independent lanes.

    The pool is allocated once; :func:`batched_lane_window` updates it in
    place (the JAX version donates the carry buffers instead).
    """
    dev = resolve_device(device)
    return [int_layer_init(cfg, n_lanes, device=dev) for cfg in net.layers]


def lane_state_take(states, lane: int) -> list:
    """Snapshot one lane's per-layer carry out of a pool (host numpy copy).

    Restoring it with :func:`lane_state_put` and continuing from the same
    local step is bit-exact with an uninterrupted run.
    """
    return [LayerState(*(a[lane].cpu().numpy().copy() for a in st)) for st in states]


def lane_states_take(states, lanes) -> list:
    """:func:`lane_state_take` of several lanes at once: one gather over the
    pool and one device->host copy, where taking them lane by lane copies
    once per leaf per lane.  Returns one snapshot per lane, in ``lanes``
    order, each equal to ``lane_state_take(states, lane)``."""
    lanes = list(lanes)
    if not lanes:
        return []
    leaves = [a for st in states for a in st]  # the pool's leaves are all int32
    idx = torch.as_tensor(lanes, device=leaves[0].device)
    host = torch.cat(leaves, dim=1).index_select(0, idx).cpu().numpy()
    edges = np.cumsum([0] + [a.shape[1] for a in leaves])
    snaps = []
    for row in host:
        parts = [row[lo:hi].copy() for lo, hi in zip(edges[:-1], edges[1:])]
        snaps.append([LayerState(*parts[3 * l : 3 * l + 3]) for l in range(len(states))])
    return snaps


def lane_state_put(states, lane: int, carry) -> list:
    """Write a :func:`lane_state_take` snapshot into the pool at ``lane``
    (in place; any slot).  Returns the pool."""
    for st, snap in zip(states, carry):
        for a, v in zip(st, snap):
            a[lane].copy_(torch.as_tensor(np.asarray(v)).to(device=a.device, dtype=a.dtype))
    return states


def _ff_currents_f32_exact(x, w_ff):
    """Feed-forward chunk integration through the f32 GEMM, bit-exactly.

    The caller guarantees ``max_spike * n_in * int_max(w_bits) < 2**24``, so
    every product and partial sum is an exact f32 integer.
    """
    T, B, n_in = x.shape
    return exact_f32_matmul(x.reshape(T * B, n_in), w_ff).reshape(T, B, -1)


def batched_lane_window(
    net,
    qparams,
    states,
    x_chunk,
    reset_mask,
    valid_steps=None,
    ff_mode="int32",
    event_budget=None,
):
    """Advance every lane by ``k`` time steps through the whole core stack.

    ``states``   -- the lane pool from :func:`batched_lane_init`; it is
                    updated *in place* (the pool is preallocated on the
                    device and reused every call) and also returned;
    ``x_chunk``  -- int [k, n_lanes, n_in], each lane's raster slice from its
                    own local step (inactive lanes / steps: zeros);
    ``reset_mask`` -- bool [n_lanes], lanes zeroed before stepping (newly
                    admitted);
    ``valid_steps`` -- optional int [n_lanes]: how many of the chunk's steps
                    fall inside each lane's window.  Outputs past it are
                    masked and the lane's carry is frozen at that boundary,
                    so a lane may complete mid-chunk bit-exactly.

    ``ff_mode`` picks the feed-forward product: ``"int32"`` (exact, the
    ``spike_matmul`` kernel on the card) or ``"f32_exact"`` (the f32 GEMM;
    the caller has checked ``max_spike_value * n_in * int_max(w_bits) <
    2**24`` for every layer).  ``event_budget`` routes layer 0 through the
    fixed-capacity sparse path (``sparse_accum`` on the card) at that
    budget; the caller guarantees the capacity + exactness contract.

    Returns ``(states, out_spikes [k, n_lanes, n_classes], emitted
    [k, n_layers, n_lanes])``.  Phase B runs the step loop of
    ``int_layer_window_carry`` (it needs the carry and the ``live`` freeze,
    which the ``lif_scan`` kernel does not take).
    """
    for st in states:
        for a in st:
            a.masked_fill_(reset_mask[:, None], 0)
    k = x_chunk.shape[0]
    x = x_chunk.to(torch.int32)
    live = None
    if valid_steps is not None:
        live = torch.arange(k, device=x.device)[:, None] < valid_steps[None, :]  # [k, n_lanes]
    emitted = []
    for li, (cfg, p, st) in enumerate(zip(net.layers, qparams, states)):
        if li == 0 and event_budget is not None:
            currents = sparse_accum_currents(x, p.w_ff, min(event_budget, cfg.n_in))
        elif ff_mode == "f32_exact":
            currents = _ff_currents_f32_exact(x, p.w_ff)
        else:
            currents = spike_integrate(x, p.w_ff)
        new_st, x = int_layer_window_carry(cfg, p, st, currents, live=live)
        for dst, src in zip(st, new_st):
            dst.copy_(src)
        emitted.append(_count(x))  # [k, n_lanes]
    out_spikes = x
    emitted = torch.stack(emitted, dim=1)  # [k, n_layers, n_lanes]
    if live is not None:
        live_i = live.to(torch.int32)
        out_spikes = out_spikes * live_i[:, :, None]
        emitted = emitted * live_i[:, None, :]
    return states, out_spikes, emitted


def batched_lane_tick(net, qparams, states, x_t, reset_mask, event_budget=None):
    """Single-step form of :func:`batched_lane_window`; returns ``(states,
    out_spikes [n_lanes, n_classes], emitted [n_layers, n_lanes])``."""
    states, out, emitted = batched_lane_window(
        net, qparams, states, x_t[None], reset_mask, event_budget=event_budget
    )
    return states, out[0], emitted[0]


def run_int_batched(net, qparams, rasters, lengths=None, mesh=None) -> SimRecord:
    """One lockstep run over a ragged batch of variable-length samples.

    ``rasters`` int [T_max, B, n_in] (tensor or numpy; numpy follows the
    parameters' device), each sample zero-padded; ``lengths`` int [B] (None =
    all full length).  A sample's contributions are masked past its own
    length, so every per-sample slice of the record is bit-exact with a
    serial ``run_int`` over that sample's unpadded window.

    ``mesh`` (``None`` | ``"auto"`` | int | ``repro_torch.core.shard.
    DeviceMesh``) spreads the sample axis across devices -- still bit-exact
    per sample (lanes are independent); see ``repro_torch.core.shard``.
    """
    if mesh is not None:
        from repro_torch.core import shard as shard_lib  # deferred: shard imports us

        return shard_lib.run_int_batched_sharded(net, qparams, rasters, lengths, mesh)
    device = qparams[0].w_ff.device
    rasters = torch.as_tensor(rasters).to(device=device, dtype=torch.int32)
    T, B, _ = rasters.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=device)
    else:
        lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
        if tuple(lengths.shape) != (B,):
            raise ValueError(f"lengths must be [B]={B}, got {tuple(lengths.shape)}")
    states = [int_layer_init(cfg, B, device=device) for cfg in net.layers]
    ts = torch.arange(T, device=device)
    live = (ts[:, None] < lengths[None, :]).to(torch.int32)  # [T, B]
    out_spikes, emitted = [], [[] for _ in net.layers]
    for t in range(T):
        x = rasters[t]
        for li, (cfg, p) in enumerate(zip(net.layers, qparams)):
            states[li], x = int_layer_step(cfg, p, states[li], x)
            emitted[li].append(_count(x) * live[t])
        out_spikes.append(x * live[t][:, None])
    if T:
        counts = _count(torch.stack(out_spikes), dim=0)
        layer_spikes = [torch.stack(e) for e in emitted]
    else:
        counts = torch.zeros(B, net.n_classes, dtype=torch.int32, device=device)
        layer_spikes = [torch.zeros(0, B, dtype=torch.int32, device=device) for _ in net.layers]
    return SimRecord(
        spike_counts=counts,
        layer_spikes=layer_spikes,
        input_events=_count(rasters != 0) * live,
    )
