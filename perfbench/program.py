"""The program under test, built from a configuration file: the port's
``NetworkConfig``, its float parameters, and a configuration's search space.
The only module of the harness besides the drivers that imports the port."""

from __future__ import annotations

import itertools

from repro_torch.core.network import NetworkConfig
from repro_torch.core.snn_layer import (
    FloatLayerParams,
    LayerConfig,
    NeuronModel,
    ResetMode,
    Topology,
)


def network(config: dict) -> NetworkConfig:
    net = config["network"]
    layers = tuple(
        LayerConfig(
            n_in=l["n_in"],
            n_out=l["n_out"],
            neuron=NeuronModel(l["neuron"]),
            topology=Topology(l["topology"]),
            reset=ResetMode(l["reset"]),
            w_bits=l["w_bits"],
            w_rec_bits=l["w_rec_bits"],
            u_bits=l["u_bits"],
            i_bits=l["i_bits"],
            leak_bits=l["leak_bits"],
            beta=l["beta"],
            alpha=l["alpha"],
            threshold=l["threshold"],
        )
        for l in net["layers"]
    )
    return NetworkConfig(layers=layers, n_steps=net["n_steps"], name=config["name"])


def float_params(weights) -> list[FloatLayerParams]:
    return [FloatLayerParams(*w) for w in weights]


def space(config: dict, max_bits: int | None = None) -> list[tuple[int, int, int]]:
    """Every (ff_bits, rec_bits, leak_bits) of the configuration's space, in
    the explorer's order; ``rec_bits`` follows ``ff_bits`` where the space has
    none; ``max_bits`` keeps the weights at most that wide."""
    sp = config["space"]
    ff = [b for b in sp["ff_bits"] if max_bits is None or b <= max_bits]
    if "rec_bits" in sp:
        rec = [b for b in sp["rec_bits"] if max_bits is None or b <= max_bits]
        return list(itertools.product(ff, rec, sp["leak_bits"]))
    return [(a, a, c) for a, c in itertools.product(ff, sp["leak_bits"])]


def candidate(net: NetworkConfig, cfg: tuple[int, int, int]) -> NetworkConfig:
    return net.replace_precisions(w_bits=cfg[0], w_rec_bits=cfg[1], leak_bits=cfg[2])
