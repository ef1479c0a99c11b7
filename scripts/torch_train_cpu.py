#!/usr/bin/env python3
"""The port's training slice on the CPU, at the configurations chip_smoke.py
drives on the card (phases 9 and 10), as a reference for what the card
should read.

    PYTHONPATH=src python scripts/torch_train_cpu.py

1. examples/quickstart.py's network (256-128-10 LIF w6/u8, T = 25) trained
   8 epochs with ``train_snn(device="cpu")`` from
   ``torch.Generator().manual_seed(0)``, deployed through ``quantize_params``
   -> ``eval_int`` on the three backends, then a QAT epoch at w_bits = 3;
2. benchmarks/dse_bench.py's network (ATA-F hidden layer, T = 20) trained 6
   epochs, then the NSGA-II search of chip_smoke.py phase 9 on the random
   and on the trained weights (front size and accuracy span of each), and
   the trained search with ``RefineSpec(top_k=4, epochs=1)``.

Takes about half a minute on 4 CPU threads; float sums can depend on the
thread count, so the thread count is fixed.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.flexplorer.cost import CostWeights  # noqa: E402
from repro_torch.core.flexplorer.explorer import (  # noqa: E402
    EvalSpec,
    RefineSpec,
    SearchSpec,
    SNNSearchSpace,
    explore_snn,
)
from repro_torch.core.flexplorer.strategies import NSGAConfig  # noqa: E402
from repro_torch.core.network import NetworkConfig, init_float_params, quantize_params  # noqa: E402
from repro_torch.core.snn_layer import LayerConfig, NeuronModel, Topology  # noqa: E402
from repro_torch.data.snn_datasets import mnist_like  # noqa: E402
from repro_torch.snn.qat import PrecisionConfig, eval_qat  # noqa: E402
from repro_torch.snn.train import eval_int, train_snn  # noqa: E402

CPU = "cpu"
DSE_WEIGHTS = dict(c_hw=0.4, c_acc=0.4, c_perf=0.2, c_lat=0.4, c_energy=0.4, c_bw=0.2)


def quickstart() -> None:
    train, test = mnist_like(n=2048, T=25, seed=0).split()
    net = NetworkConfig(
        layers=(
            LayerConfig(n_in=256, n_out=128, w_bits=6, u_bits=8, beta=0.95),
            LayerConfig(n_in=128, n_out=10, w_bits=6, u_bits=8, beta=0.95),
        ),
        n_steps=25,
        name="quickstart-mnist",
    )
    params = init_float_params(torch.Generator().manual_seed(0), net, device=CPU)
    t0 = time.perf_counter()
    res = train_snn(net, train, epochs=8, batch_size=128, lr=2e-3, init_params=params, device=CPU)
    print(f"quickstart: trained in {time.perf_counter() - t0:.3f} s; last epoch {res.history[-1]}")
    qparams, _ = quantize_params(net, res.params)
    for backend in ("reference", "fused", "event"):
        print(f"quickstart: deployed accuracy [{backend}] {eval_int(net, qparams, test, backend=backend)}")
    qres = train_snn(net, train, epochs=1, lr=5e-4, qat=PrecisionConfig(w_bits=3),
                     init_params=res.params, device=CPU)
    qq, _ = quantize_params(qres.qat_net, qres.params)
    print(f"quickstart: QAT w3 epoch loss {qres.history[0]['loss']:.6f}; eval_int "
          f"{eval_int(qres.qat_net, qq, test)}, eval_qat {eval_qat(qres.qat_net, qres.params, test)}")


def summary(res) -> str:
    accs = [t["accuracy"] for t in res.search.trace]
    explored = res.explored_front()
    return (
        f"front {len(res.search.front)} points, explored (hw, accuracy) front {len(explored)} "
        f"points {[round(p['accuracy'], 4) for p in explored]}, accuracy span "
        f"{min(accs):.6f}..{max(accs):.6f}"
    )


def dse() -> None:
    train, test = mnist_like(n=1536, T=20, seed=0).split()
    net = NetworkConfig(
        layers=(
            LayerConfig(n_in=256, n_out=128, neuron=NeuronModel.LIF, topology=Topology.ATA_F,
                        w_bits=6, u_bits=16),
            LayerConfig(n_in=128, n_out=10, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
        ),
        n_steps=20,
        name="dse-bench-mnist-256-128-10",
    )
    bits = tuple(range(2, 17))
    space = SNNSearchSpace(ff_bits=bits, rec_bits=bits, leak_bits=tuple(range(1, 9)))
    random = init_float_params(torch.Generator().manual_seed(0), net, device=CPU)
    res = train_snn(net, train, epochs=6, batch_size=128, lr=2e-3, init_params=random, device=CPU)
    print(f"dse: trained; last epoch {res.history[-1]}")

    def search(params, refine=None):
        return explore_snn(
            net, params, test,
            search=SearchSpec(space=space, weights=CostWeights(**DSE_WEIGHTS), strategy="nsga2",
                              config=NSGAConfig(population=64, generations=3, seed=0)),
            evaluate=EvalSpec(batch=len(test.labels)),
            refine=refine,
        )

    print(f"dse: random weights: {summary(search(random))}")
    refined = search(res.params, RefineSpec(top_k=4, train_ds=train, epochs=1))
    print(f"dse: trained weights: {summary(refined)}")
    for r in refined.refined:
        print(f"dse: refined {r.breakdown}: {r.base_accuracy:.6f} -> {r.accuracy:.6f}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    quickstart()
    dse()
