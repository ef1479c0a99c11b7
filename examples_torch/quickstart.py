"""Quickstart on the port: train a Flexi-NeurA SNN, quantize it, check
bit-exact accuracy.

    PYTHONPATH=src python examples_torch/quickstart.py               # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

Trains the paper's 256-128-10 LIF network on the synthetic MNIST stand-in,
quantizes its weights to 6 bits, evaluates the hardware-bit-exact simulator
through the event backend, and prints the hardware model's resources,
latency and power (the paper's FPGA at 60 MHz, a model, not a time of the
device this runs on) next to the paper's reported design point, and the
device's own train and evaluation walls.  The weights start from
``torch.Generator().manual_seed(0)``, not from ``jax.random``, so the
accuracy differs from the JAX example's.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import device_label, resolve_device
from repro_torch.core import hw_model
from repro_torch.core.network import NetworkConfig, quantize_params
from repro_torch.core.snn_layer import LayerConfig
from repro_torch.data.snn_datasets import mnist_like
from repro_torch.snn.train import eval_int, train_snn

NET = NetworkConfig(
    layers=(
        LayerConfig(n_in=256, n_out=128, w_bits=6, u_bits=8, beta=0.95),
        LayerConfig(n_in=128, n_out=10, w_bits=6, u_bits=8, beta=0.95),
    ),
    n_steps=25,
    name="quickstart-mnist",
)


def _synced_wall(t0: float, dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def run(device: str | torch.device = "cuda", n: int = 2048) -> dict:
    """Train on ``mnist_like(n, T=25, seed=0)``'s 85 % (8 epochs, batch 128,
    lr 2e-3), quantize, evaluate the other 15 % on the event backend with
    its event statistics, and model the design point from them."""
    dev = resolve_device(device)
    train, test = mnist_like(n=n, T=NET.n_steps, seed=0).split()
    t0 = time.perf_counter()
    res = train_snn(NET, train, epochs=8, batch_size=128, lr=2e-3, log_every=2, device=dev)
    train_s = _synced_wall(t0, dev)
    qparams, scales = quantize_params(NET, res.params)
    # the event-driven backend exploits the trained network's sparsity;
    # bit-exact vs reference, so the accuracy is the same number
    t0 = time.perf_counter()
    acc, stats = eval_int(NET, qparams, test, return_stats=True, backend="event")
    eval_s = _synced_wall(t0, dev)
    traffic = hw_model.EventTraffic.from_stats(stats)
    return dict(
        net=NET, train=train, test=test, result=res, qparams=qparams, scales=scales,
        accuracy=acc, stats=stats, resources=hw_model.network_resources(NET),
        traffic=traffic, design=hw_model.design_point(NET, traffic),
        train_s=train_s, eval_s=eval_s, device=dev,
    )


def report(out: dict) -> None:
    net, r, dp = out["net"], out["resources"], out["design"]
    print(f"\nbit-exact quantized accuracy: {out['accuracy']:.4f}  (paper on real MNIST: 0.9723)")
    print("the paper's FPGA, modeled at 60 MHz (not a time of this device):")
    print(f"  resources: {r.logic_cells:.0f} logic cells ({r.lut:.0f} LUT + {r.ff:.0f} FF), "
          f"{r.bram} BRAM  (paper: 1623, 7)")
    print(f"  latency:   {dp.latency_s * 1e3:.2f} ms/img @ 60 MHz at {dp.events_per_image:.0f} "
          f"events/img  (paper: 1.1 ms at T=100)")
    print(f"  power:     {dp.power_w * 1e3:.0f} mW, energy {dp.energy_per_image_j * 1e3:.3f} "
          f"mJ/img  (paper: 111 mW, 0.12 mJ)")
    n_test = len(out["test"].labels)
    print(f"measured on {device_label(out['device'])}: training {out['train_s']:.3f} s, "
          f"event-backend evaluation of {n_test} samples {out['eval_s']:.3f} s "
          f"({n_test / out['eval_s']:.1f} samples/s)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=2048, help="dataset size (tests shrink it)")
    args = ap.parse_args(argv)
    print(f"training {NET.name} (LIF 256-128-10, 6-bit weights) on {args.device}...")
    out = run(args.device, n=args.n)
    report(out)
    return out


if __name__ == "__main__":
    main()
