"""Multi-core Flexi-NeurA network: configs, the train->deploy path, simulation.

Port of ``repro/core/network.py``: :func:`init_float_params` /
:func:`quantize_params` (float weights quantized to each core's fixed-point
widths, thresholds rescaled onto the same grid), :func:`run_float`, the
differentiable simulation BPTT trains through, and :func:`run_int`, the
bit-exact deployment simulation, both through any registered backend.
:func:`float_params_from_numpy` / :func:`int_params_from_numpy` carry
parameters across from the JAX package (as numpy arrays), so both packages
can compute on identical weights.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.backend import InferenceBackend, SimRecord, get_backend
from repro_torch.core.fixed_point import int_max
from repro_torch.core.snn_layer import FloatLayerParams, IntLayerParams, LayerConfig, Topology

__all__ = [
    "NetworkConfig",
    "init_float_params",
    "float_params_from_numpy",
    "int_params_from_numpy",
    "layer_scale",
    "quantize_params",
    "run_float",
    "run_int",
    "SimRecord",
]


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """A stack of cores plus the inference window length."""

    layers: tuple[LayerConfig, ...]
    n_steps: int
    name: str = "snn"

    def __post_init__(self):
        for prev, nxt in zip(self.layers[:-1], self.layers[1:]):
            if prev.n_out != nxt.n_in:
                raise ValueError(
                    f"layer size mismatch: {prev.n_out} -> {nxt.n_in} in {self.name}"
                )

    @property
    def n_in(self) -> int:
        return self.layers[0].n_in

    @property
    def n_classes(self) -> int:
        return self.layers[-1].n_out

    def replace_precisions(self, w_bits=None, w_rec_bits=None, leak_bits=None):
        """A new config with uniformly overridden DSE knobs (None = keep)."""
        new_layers = []
        for lc in self.layers:
            new_layers.append(
                dataclasses.replace(
                    lc,
                    w_bits=w_bits if w_bits is not None else lc.w_bits,
                    w_rec_bits=w_rec_bits if w_rec_bits is not None else lc.w_rec_bits,
                    leak_bits=leak_bits if leak_bits is not None else lc.leak_bits,
                )
            )
        return dataclasses.replace(self, layers=tuple(new_layers))


def _uniform(gen: torch.Generator, shape, lim: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (2 * lim) - lim


def init_float_params(
    gen: torch.Generator, net: NetworkConfig, device: str | torch.device = "cuda"
) -> list[FloatLayerParams]:
    """Random float parameters, uniform(+-1/sqrt(fan_in)) as in torch.nn.Linear.

    Drawn from ``gen`` (a CPU ``torch.Generator``) and then moved to
    ``device``, so a seed gives the same weights on every device.  Not
    expected to match ``jax.random``; use :func:`float_params_from_numpy` to
    share weights with the JAX package.
    """
    dev = resolve_device(device)
    params = []
    for cfg in net.layers:
        w_ff = _uniform(gen, (cfg.n_in, cfg.n_out), 1.0 / np.sqrt(cfg.n_in))
        if cfg.topology == Topology.ATA_T:
            w_rec = _uniform(gen, (cfg.n_out, cfg.n_out), 1.0 / np.sqrt(cfg.n_out))
        elif cfg.topology == Topology.ATA_F:
            w_rec = torch.tensor(0.1, dtype=torch.float32)  # shared self-weight register
        else:
            w_rec = torch.zeros(0, dtype=torch.float32)
        theta = torch.tensor(cfg.threshold, dtype=torch.float32)
        params.append(FloatLayerParams(w_ff=w_ff.to(dev), w_rec=w_rec.to(dev), theta=theta.to(dev)))
    return params


def float_params_from_numpy(
    net: NetworkConfig, arrays, device: str | torch.device = "cuda"
) -> list[FloatLayerParams]:
    """Float parameters from per-layer ``(w_ff, w_rec, theta)`` numpy arrays
    (``np.asarray`` of each field of the JAX package's ``FloatLayerParams``)."""
    dev = resolve_device(device)
    if len(arrays) != len(net.layers):
        raise ValueError(f"{len(arrays)} layers of arrays for a {len(net.layers)}-layer net")
    return [
        FloatLayerParams(*(torch.from_numpy(np.array(a, np.float32)).to(dev) for a in layer))
        for layer in arrays
    ]


def int_params_from_numpy(
    net: NetworkConfig, arrays, device: str | torch.device = "cuda"
) -> list[IntLayerParams]:
    """Quantized parameters from per-layer ``(w_ff, w_rec, theta_q)`` numpy
    arrays (``np.asarray`` of each field of the JAX ``IntLayerParams``)."""
    dev = resolve_device(device)
    if len(arrays) != len(net.layers):
        raise ValueError(f"{len(arrays)} layers of arrays for a {len(net.layers)}-layer net")
    return [
        IntLayerParams(*(torch.from_numpy(np.array(a, np.int32)).to(dev) for a in layer))
        for layer in arrays
    ]


def layer_scale(cfg, p: FloatLayerParams, w_max=None, rec_max=None) -> torch.Tensor:
    """The core's float->fixed-point quantization scale, a float32 tensor.

    The tightest scale that fits both weight groups in their bit-widths and
    keeps the rescaled threshold at most half the membrane register.  Every
    operation is float32 in the same order as the JAX version, so the scale
    -- and every ``theta_q`` and spike after it -- matches bit for bit.

    ``w_max`` / ``rec_max`` override the weight-grid maxima (``int_max(w_bits)``
    / ``int_max(w_rec_bits)``) with float32 values of shape [] or [K].  With
    a leading candidate axis on ``p`` (``w_ff`` [K, n_in, n_out], stacked
    ``w_rec`` and ``theta``, as the population fine-tune holds them) the
    scale is [K], each candidate's equal to the scale of its own slice.
    """
    f32 = torch.float32
    dev = p.w_ff.device
    eps = torch.tensor(1e-12, dtype=f32, device=dev)
    w_max = torch.as_tensor(int_max(cfg.w_bits) if w_max is None else w_max, dtype=f32).to(dev)
    rec_max = torch.as_tensor(
        int_max(cfg.w_rec_bits) if rec_max is None else rec_max, dtype=f32
    ).to(dev)
    absmax_ff = torch.abs(p.w_ff.to(f32)).amax(dim=(-2, -1))
    absmax_ff = torch.where(absmax_ff == 0, eps, absmax_ff)
    scale = w_max / absmax_ff
    if cfg.topology == Topology.ATA_T and p.w_rec.numel():
        absmax_rec = torch.abs(p.w_rec.to(f32)).amax(dim=(-2, -1))
        scale = torch.minimum(scale, rec_max / torch.where(absmax_rec == 0, eps, absmax_rec))
    elif cfg.topology == Topology.ATA_F:
        absmax_rec = torch.abs(p.w_rec.to(f32))
        scale = torch.minimum(scale, rec_max / torch.where(absmax_rec == 0, eps, absmax_rec))
    theta = torch.as_tensor(p.theta, dtype=f32).to(dev)
    theta = torch.where(theta == 0, eps, theta)
    half_u = torch.tensor(0.5 * int_max(cfg.u_bits), dtype=f32, device=dev)
    return torch.minimum(scale, half_u / theta)


def quantize_params(
    net: NetworkConfig, params: Sequence[FloatLayerParams]
) -> tuple[list[IntLayerParams], list[float]]:
    """Quantize float weights onto each core's fixed-point grid.

    Scale from :func:`layer_scale`; round half to even (``torch.round``, as
    ``jnp.round``) with clipping onto the signed grid.
    """
    qparams, scales = [], []
    for cfg, p in zip(net.layers, params):
        scale = layer_scale(cfg, p)
        w_ff_q = torch.clamp(
            torch.round(p.w_ff * scale), -int_max(cfg.w_bits) - 1, int_max(cfg.w_bits)
        ).to(torch.int32)
        if cfg.topology in (Topology.ATA_T, Topology.ATA_F):
            w_rec_q = torch.clamp(
                torch.round(p.w_rec * scale),
                -int_max(cfg.w_rec_bits) - 1,
                int_max(cfg.w_rec_bits),
            ).to(torch.int32)
        else:
            w_rec_q = torch.zeros(0, dtype=torch.int32, device=p.w_ff.device)
        theta_q = torch.round(p.theta * scale).to(torch.int32)
        qparams.append(IntLayerParams(w_ff=w_ff_q, w_rec=w_rec_q, theta_q=theta_q))
        scales.append(float(scale))
    return qparams, scales


def run_int(
    net: NetworkConfig,
    qparams: Sequence[IntLayerParams],
    spikes_in,
    backend: str | InferenceBackend = "reference",
) -> SimRecord:
    """Bit-exact deployment simulation. ``spikes_in``: int [T, batch, n_in]."""
    return get_backend(backend).run_int(net, list(qparams), spikes_in)


def run_float(
    net: NetworkConfig,
    params: Sequence[FloatLayerParams],
    spikes_in,
    spike_fn,
    backend: str | InferenceBackend = "reference",
) -> SimRecord:
    """Differentiable simulation. ``spikes_in``: float {0,1} [T, batch, n_in]."""
    return get_backend(backend).run_float(net, list(params), spikes_in, spike_fn)
