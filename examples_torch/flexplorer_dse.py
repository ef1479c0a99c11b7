"""Flex-plorer end to end on the port: train -> anneal -> QAT-refine ->
deployment package.

    PYTHONPATH=src python examples_torch/flexplorer_dse.py               # on the card
    PYTHONPATH=src python examples_torch/flexplorer_dse.py --device cpu

The paper's full flow (Fig. 10) plus the train-in-the-loop second phase: the
Learning stage trains an ATA-F LIF network on the DVS stand-in; the Explorer
anneals (ff bits, rec bits, leak precision) against the weighted LUT/FF/BRAM
+ bit-exact-accuracy cost; the refine phase QAT-fine-tunes the two best
finalists at their own precisions (epoch 0 is post-training quantization,
so refinement never loses accuracy on the scoring set); the "RTL
Configurator" stage writes the deployment package -- chosen design-time
parameters, quantized weight tables and an encoded dataset sample, with the
JAX example's file names, keys and array names and dtypes -- under
``--out`` (default ``runs/flexplorer_pkg_torch``, beside and never over the
JAX example's ``runs/flexplorer_pkg``), from the best *refined* candidate
when one dominates the annealer's pick.  The float weights start from
``torch.Generator().manual_seed(0)``, not from ``jax.random``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch._device import device_label, resolve_device
from repro_torch.core import hw_model
from repro_torch.core.flexplorer import annealer as annealer_lib
from repro_torch.core.flexplorer import cost as cost_lib
from repro_torch.core.flexplorer.explorer import (
    RefineSpec,
    SearchSpec,
    SNNSearchSpace,
    explore_snn,
)
from repro_torch.core.network import NetworkConfig
from repro_torch.core.snn_layer import LayerConfig, NeuronModel, Topology
from repro_torch.data.snn_datasets import dvs_like
from repro_torch.snn.train import train_snn

NET = NetworkConfig(
    layers=(
        LayerConfig(n_in=256, n_out=128, neuron=NeuronModel.LIF, topology=Topology.ATA_F,
                    u_bits=16),
        LayerConfig(n_in=128, n_out=11, neuron=NeuronModel.LIF, topology=Topology.FF, u_bits=16),
    ),
    n_steps=20,
    name="dvs-ataf",
)
SEARCH = SearchSpec(
    space=SNNSearchSpace(ff_bits=(3, 4, 6, 8), rec_bits=(3, 4, 6, 8), leak_bits=(3, 8)),
    weights=cost_lib.CostWeights(c_hw=0.5, c_acc=0.5, c_lut=0.33, c_ff=0.33, c_bram=0.34),
    config=annealer_lib.AnnealConfig(t_start=1.0, t_min=0.05, alpha=0.6, eval_divisor=3, seed=0),
)


def net_resources(net: NetworkConfig) -> dict:
    res = hw_model.network_resources(net)
    return {
        "lut": float(res.lut),
        "ff": float(res.ff),
        "bram": float(res.bram),
        "logic_cells": float(res.logic_cells),
    }


def design(net: NetworkConfig) -> dict:
    """``design.json``'s content: the design-time parameters of each core
    and the resources of the deployed net."""
    return {
        "layers": [
            {"n_in": lc.n_in, "n_out": lc.n_out, "neuron": lc.neuron.value,
             "topology": lc.topology.value, "w_bits": lc.w_bits,
             "w_rec_bits": lc.w_rec_bits, "leak_bits": lc.leak_bits,
             "decay_register": lc.beta_code().decay_rate_register}
            for lc in net.layers
        ],
        "resources": net_resources(net),
    }


def explore(device: str | torch.device = "cuda", n: int = 1408) -> dict:
    """Learning and Explorer stages: ``dvs_like(n, T=20, seed=2)``, ``train_snn``
    (6 epochs, batch 128, lr 2e-3), then the anneal with ``RefineSpec(top_k=2,
    epochs=3, lr=1.5e-3)``; picks the deployed candidate."""
    dev = resolve_device(device)
    train, test = dvs_like(n=n, T=NET.n_steps, seed=2).split()
    t0 = time.perf_counter()
    res = train_snn(NET, train, epochs=6, batch_size=128, lr=2e-3, log_every=2, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = explore_snn(NET, res.params, test, search=SEARCH,
                         refine=RefineSpec(top_k=2, train_ds=train, epochs=3, lr=1.5e-3))
    explore_s = time.perf_counter() - t0
    # deploy the best refined candidate when one beats the annealer's pick
    # at no higher total cost; the PTQ incumbent otherwise
    best_refined = min(result.refined, key=lambda r: r.total_cost, default=None)
    refined = best_refined is not None and best_refined.total_cost <= result.anneal.best_cost
    if refined:
        deploy_net, deploy_qparams = best_refined.net, best_refined.qparams
    else:
        deploy_net, deploy_qparams = result.best_net, result.best_qparams
    return dict(train=train, test=test, result=result, deploy_net=deploy_net,
                deploy_qparams=deploy_qparams, deployed_refined=best_refined if refined else None,
                train_s=train_s, explore_s=explore_s, device=dev)


def write_package(out_dir, deploy_net, deploy_qparams, test) -> pathlib.Path:
    """design.json, weights_q.npz (``layer{i}_wff``, int32) and
    encoded_sample.npy (the first 16 test rasters, uint8) under ``out_dir``."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "design.json").write_text(json.dumps(design(deploy_net), indent=2))
    np.savez(out / "weights_q.npz", **{
        f"layer{i}_wff": q.w_ff.cpu().numpy() for i, q in enumerate(deploy_qparams)
    })
    np.save(out / "encoded_sample.npy", test.spikes[:16])
    return out


def report(found: dict, out: pathlib.Path) -> None:
    result = found["result"]
    print("chosen configuration:", json.dumps(result.report()["chosen"], indent=2, default=float))
    print("explored (PTQ) Pareto front:", json.dumps(result.explored_front(), default=float))
    print("refined Pareto front:      ", json.dumps(result.refined_front(), default=float))
    for r in result.refined:
        print(f"  refined {r.breakdown}: {r.base_accuracy:.4f} -> {r.accuracy:.4f}")
    if found["deployed_refined"] is not None:
        print(f"deploying refined candidate {found['deployed_refined'].breakdown}")
    else:
        print("deploying the unrefined annealer incumbent")
    print(f"deployment package written to {out}/ (design.json, weights_q.npz, encoded_sample.npy)")
    print(f"measured on {device_label(found['device'])}: training {found['train_s']:.3f} s, "
          f"search and refine {found['explore_s']:.3f} s "
          f"({len(result.search.cache)} candidates scored)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="runs/flexplorer_pkg_torch", help="package directory")
    ap.add_argument("--n", type=int, default=1408, help="dataset size (tests shrink it)")
    args = ap.parse_args(argv)
    print(f"Learning stage: training ATA-F LIF on the DVS stand-in on {args.device}...")
    found = explore(args.device, n=args.n)
    print("Explorer stage: simulated annealing over (ff, rec, leak) precision, then QAT refine")
    out = write_package(args.out, found["deploy_net"], found["deploy_qparams"], found["test"])
    report(found, out)
    found["out"] = out
    return found


if __name__ == "__main__":
    main()
