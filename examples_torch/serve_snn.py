"""Continuous-batching SNN serving on the port, over the backend registry.

    PYTHONPATH=src python examples_torch/serve_snn.py               # on the card
    PYTHONPATH=src python examples_torch/serve_snn.py --device cpu

Serves a mixed stream of quantized-SNN inference requests -- dense
mnist-like digits, two very sparse event streams, and one short window --
through ``SNNServeEngine`` with the event backend's density-based admission
policy, then re-runs every request serially through ``run_int`` and checks
that the served outputs are bit-identical (a mismatch exits with status 1).
Prints per-request predictions, wall-clock latency on the device it ran on,
the route each request took, and the modeled hardware operating point (the
paper's FPGA at 60 MHz) at each request's own event traffic.  The weights
come from ``torch.Generator().manual_seed(0)``, not from ``jax.random``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch._device import device_label, resolve_device
from repro_torch.core.network import NetworkConfig, init_float_params, quantize_params, run_int
from repro_torch.core.snn_layer import LayerConfig, NeuronModel
from repro_torch.data.snn_datasets import mnist_like, raster_tensor
from repro_torch.serve.snn_engine import SNNRequest, SNNServeEngine

T = 20
NET = NetworkConfig(
    layers=(
        LayerConfig(n_in=256, n_out=128, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
        LayerConfig(n_in=128, n_out=10, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
    ),
    n_steps=T,
    name="serve-demo-256-128-10",
)


def rasters() -> list[np.ndarray]:
    """8 dense digits, 2 sparse event streams, and a short window."""
    ds = mnist_like(n=8, T=T, seed=3)
    rng = np.random.default_rng(0)
    out = [ds.spikes[i] for i in range(8)]
    out += [(rng.random((T, 256)) < 0.02).astype(np.uint8) for _ in range(2)]
    out.append(ds.spikes[0][: T // 2])  # short request: frees its lane early
    return out


def serial_mismatches(qparams, done, device) -> list[int]:
    """uids whose served counts differ from a serial batch-1 ``run_int``."""
    bad = []
    for r in done:
        ref = run_int(NET, qparams, raster_tensor(r.raster[:, None, :], device))
        if not np.array_equal(r.spike_counts, ref.spike_counts[0].cpu().numpy()):
            bad.append(r.uid)
    return bad


def run(device: str | torch.device = "cuda") -> dict:
    """Seeded float weights through ``quantize_params``, the requests served
    with ``max_batch=4`` on the event backend, each checked against serial."""
    dev = resolve_device(device)
    params = init_float_params(torch.Generator().manual_seed(0), NET, device=dev)
    qparams, _ = quantize_params(NET, params)
    engine = SNNServeEngine(NET, qparams, max_batch=4, backend="event", device=dev)
    # run both routes once so the printed latencies are service, not first calls
    engine.warmup()
    done = engine.run([SNNRequest(uid=i, raster=r) for i, r in enumerate(rasters())])
    return dict(qparams=qparams, engine=engine, done=done,
                mismatches=serial_mismatches(qparams, done, dev), device=dev)


def report(out: dict) -> None:
    engine, done = out["engine"], out["done"]
    print(f"served {len(done)} requests on {NET.name} (max_batch=4, backend=event, "
          f"ticks={engine.n_ticks}); latencies measured on {device_label(out['device'])}")
    for r in sorted(done, key=lambda r: r.uid):
        dp = r.design
        print(
            f"  req{r.uid:>2}: T={r.n_steps:>2} density={r.density:5.1%} "
            f"route={r.route:<11} pred={r.prediction} "
            f"latency={r.latency_s * 1e3:6.2f} ms | modeled FPGA at 60 MHz: "
            f"{dp.latency_s * 1e3:5.2f} ms / {dp.energy_per_image_j * 1e3:.3f} mJ"
        )
    n_bad = len(out["mismatches"])
    print(f"\nbit-exact vs serial run_int: {len(done) - n_bad}/{len(done)} requests")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    report(out)
    if out["mismatches"]:
        # the service is an execution strategy, not a numerics change
        print(f"FAIL: served counts differ from serial run_int for uids {out['mismatches']}",
              file=sys.stderr)
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
