#!/usr/bin/env python
"""Chaos smoke on the port: one seeded fault schedule through the supervised
engine.

A fast end-to-end pass of the crash-safety path: a fixed fault schedule --
a tick exception, a carry poisoning, and a simulated process kill -- fires
against a :class:`~repro_torch.serve.supervisor.SupervisedEngine` with a
write-ahead journal, and every admitted request must come back
bit-identical to a serial ``run_int``.  The deterministic battery is
``tests/test_torch_chaos.py``; the randomized churn is the slow
``tests/test_torch_chaos_soak.py``.

    PYTHONPATH=src python scripts/chaos_smoke_torch.py [--seed N]                # on the card
    PYTHONPATH=src python scripts/chaos_smoke_torch.py --device cpu [--seed N]

Exit code 0 on success; 1 with a diagnostic on any lost, double-served, or
bit-inexact request.  The weights come from ``torch.Generator().manual_seed(
seed)``, not from ``jax.random``.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.network import NetworkConfig, init_float_params, quantize_params, run_int
from repro_torch.core.snn_layer import LayerConfig, NeuronModel
from repro_torch.data.snn_datasets import raster_tensor
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.snn_engine import SNNRequest, SNNServeEngine
from repro_torch.serve.supervisor import SupervisedEngine

NET = NetworkConfig(
    layers=(
        LayerConfig(n_in=16, n_out=10, neuron=NeuronModel.LIF, beta=0.9),
        LayerConfig(n_in=10, n_out=4, neuron=NeuronModel.LIF, beta=0.77),
    ),
    n_steps=8,
)


class SmokeFailure(Exception):
    """A request lost, served twice, or not bit-exact with serial ``run_int``."""


def deployed(seed: int, device: str | torch.device = "cuda"):
    """``NET``'s quantized weights from ``torch.Generator().manual_seed(seed)``."""
    params = init_float_params(torch.Generator().manual_seed(seed), NET, device=device)
    return quantize_params(NET, params)[0]


def request_rasters(seed: int, n_requests: int) -> dict[int, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {uid: (rng.random((8, NET.n_in)) < 0.4).astype(np.uint8) for uid in range(n_requests)}


def serve_through_faults(qparams, rasters, dev, journal_dir):
    """Every raster through the fault schedule on a journaled
    ``SupervisedEngine``: ``(uid -> served request, the supervisor, the
    injector)``.  Raises :class:`SmokeFailure` on a lost or double-served
    request."""
    inj = FaultInjector().arm("tick", at=1).arm("carry", at=2, bit=26).arm("kill", at=4)
    sup = SupervisedEngine(
        lambda: SNNServeEngine(NET, qparams, max_batch=4, tick_stride=2, device=dev),
        journal_dir=journal_dir,
        journal_fsync_every=1,
        faults=inj,
        backoff_s=1e-4,
    )
    try:
        for uid, raster in rasters.items():
            sup.submit(SNNRequest(uid=uid, raster=raster))
        completed: dict[int, SNNRequest] = {}
        while sup.in_flight:
            for req in sup.poll():
                if req.uid in completed:
                    raise SmokeFailure(f"uid {req.uid} double-served")
                completed[req.uid] = req
    finally:
        sup.close()
    missing = set(rasters) - set(completed)
    if missing:
        raise SmokeFailure(f"requests lost: {sorted(missing)}")
    return completed, sup, inj


def check_bit_exact(qparams, rasters, completed, dev) -> None:
    """Every served count equal to a serial batch-1 ``run_int`` (the oracle)."""
    for uid, req in completed.items():
        serial = run_int(NET, qparams, raster_tensor(rasters[uid][:, None, :], dev))
        serial = serial.spike_counts[0].cpu().numpy()
        if not np.array_equal(req.spike_counts, serial):
            raise SmokeFailure(
                f"uid {uid} not bit-exact vs run_int ({req.spike_counts} != {serial})"
            )


def smoke(qparams, *, seed: int = 0, n_requests: int = 12,
          device: str | torch.device = "cuda") -> int:
    """Serve ``n_requests`` seeded rasters through the fault schedule on
    ``qparams`` (on ``device``), journaled to a temporary directory; 0 if
    every request came back once and bit-exact, else 1 after a diagnostic
    on stderr."""
    dev = resolve_device(device)
    rasters = request_rasters(seed, n_requests)
    try:
        with tempfile.TemporaryDirectory(prefix="neura-chaos-wal-") as wal:
            completed, sup, inj = serve_through_faults(qparams, rasters, dev, wal)
        check_bit_exact(qparams, rasters, completed, dev)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    m = sup.metrics.counters
    routes = {k: v for k, v in sorted(m.items()) if k.startswith("tick:")}
    print(
        f"chaos smoke OK: {len(completed)} requests bit-exact through "
        f"{len(inj.fired)} injected faults "
        f"(retries={m['tick_retries']}, quarantined={m['quarantined_lanes']}, "
        f"warm={m['recoveries_warm']}, cold={m['recoveries_cold']}; ticks by route "
        f"{routes}) on {dev}"
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return smoke(deployed(args.seed, dev), seed=args.seed, n_requests=args.requests, device=dev)


if __name__ == "__main__":
    sys.exit(main())
