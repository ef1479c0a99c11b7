"""The serial oracle of the port's soaks, and the carry of a port net and its
integers to the JAX package.

A soak on the CPU replays its sampled requests through JAX's ``run_int`` on
the integers the port served with, wherever the JAX package imports and
there is no CUDA card.  A soak on a machine with a card (whose soaks measure
the port alone, and where the JAX package is not run), or on a machine
without JAX, replays them through the port's own ``run_int`` on the CPU, its
reference path (``tests/test_torch_backend.py`` holds that to JAX bit for
bit).  JAX is imported only when it is used, so the soaks run on a machine
that has none.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib.util

import numpy as np
import torch

from repro_torch.core.network import run_int


def jax_net(net):
    """The JAX package's ``NetworkConfig`` with the port net's fields."""
    from repro.core import network as jnet
    from repro.core import snn_layer as jsl

    def conv(v):
        return getattr(jsl, type(v).__name__)(v.value) if isinstance(v, enum.Enum) else v

    layers = tuple(
        jsl.LayerConfig(**{f.name: conv(getattr(lc, f.name)) for f in dataclasses.fields(lc)})
        for lc in net.layers
    )
    return jnet.NetworkConfig(layers=layers, n_steps=net.n_steps, name=net.name)


def jax_qparams(qparams):
    import jax.numpy as jnp
    from repro.core import snn_layer as jsl

    return [jsl.IntLayerParams(*(jnp.asarray(t.cpu().numpy()) for t in p)) for p in qparams]


def jax_importable() -> bool:
    return all(importlib.util.find_spec(m) is not None for m in ("jax", "repro"))


def port_serial(net, qparams, raster) -> np.ndarray:
    """Batch-1 spike counts of ``raster`` [T, n_in] through the port's
    ``run_int`` on the CPU (``qparams`` on the CPU)."""
    x = torch.from_numpy(np.asarray(raster)[:, None, :].astype(np.int32))
    return run_int(net, qparams, x).spike_counts[0].numpy()


def jax_serial(net, qparams, raster) -> np.ndarray:
    """Batch-1 spike counts of ``raster`` [T, n_in] through JAX's ``run_int``
    on the port's integers."""
    import jax.numpy as jnp
    from repro.core import network as jnet

    x = jnp.asarray(np.asarray(raster)[:, None, :], jnp.int32)
    return np.asarray(jnet.run_int(jax_net(net), jax_qparams(qparams), x).spike_counts)[0]


def serial_oracle(device: str):
    """``(name, fn(net, qparams, raster) -> counts)``: JAX's ``run_int`` for
    the CPU case where JAX imports and there is no card, else the port's on
    the CPU."""
    if device == "cpu" and not torch.cuda.is_available() and jax_importable():
        return "JAX run_int", jax_serial
    return "the port's CPU run_int", port_serial
