#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero before the
result line):

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of the
   three CUDA kernels from ``src/repro_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, bit for bit,
   at the main path's shapes, timed with CUDA events beside its plain
   version, a PyTorch library call where one computes the same function,
   and its roofline bound;
3. ``run_int`` of the 256-128-10 LIF network (w6/u16, T=25, random weights
   from a seeded generator) on a ``mnist_like`` batch of 1024 through the
   ``reference``, ``fused`` and ``event`` (pallas strategy) backends: every
   record field identical, and identical to the CPU on a slice;
4. ``eval_int`` on ``mnist_like(n=4096, T=25)`` at batch 4096 through
   ``fused`` and ``event``: equal accuracy and event statistics;
5. ``SNNServeEngine`` (64 lanes, pallas event backend) on 256 ragged
   requests -- sparse, dense and graded -- each bit-exact with a serial
   ``run_int(reference)`` of its own raster;
6. a ``kernels`` JSON line (launches on phases 3-5, times, bounds);
7. the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.core.backend import EventBackend  # noqa: E402
from repro_torch.core.network import (  # noqa: E402
    NetworkConfig,
    init_float_params,
    quantize_params,
    run_int,
)
from repro_torch.core.snn_layer import LayerConfig, NeuronModel  # noqa: E402
from repro_torch.data.snn_datasets import mnist_like, raster_tensor  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.lif_scan.lif_scan import lif_scan  # noqa: E402
from repro_torch.kernels.lif_scan.ref import lif_scan_ref  # noqa: E402
from repro_torch.kernels.quant_matmul.spike_matmul import (  # noqa: E402
    spike_matmul,
    spike_matmul_plain,
)
from repro_torch.kernels.sparse_accum.ops import fixed_capacity_events  # noqa: E402
from repro_torch.kernels.sparse_accum.ref import sparse_accum_ref  # noqa: E402
from repro_torch.kernels.sparse_accum.sparse_accum import sparse_accum  # noqa: E402
from repro_torch.serve.snn_engine import SNNRequest, SNNServeEngine  # noqa: E402
from repro_torch.snn.train import eval_int  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper, dense, 700 W).
HBM_BYTES_S = 3.35e12
INT8_TC_OPS_S = 1979e12  # int8 tensor cores
INT32_OPS_S = 33.5e12  # int32 on the CUDA cores
BINARY_SERVE_BUDGET = 64  # EventBackend().serve_budget(256, 0.10)
DEVICE = "cuda"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 15, inner: int = 10, warmup: int = 3) -> float:
    """Median per-launch milliseconds over ``reps`` CUDA-event windows of
    ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def bound(n_bytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def fits_int8(*ts) -> bool:
    return all(int(t.min()) >= -128 and int(t.max()) <= 127 for t in ts)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_spike_matmul(gen, w_main) -> dict:
    dev = DEVICE
    err = 0
    spikes = (torch.rand(25 * 1024, 256, device=dev, generator=gen) < 0.12).to(torch.int32)
    cases = [
        (spikes, w_main[0]),
        (
            (torch.rand(25 * 1024, 128, device=dev, generator=gen) < 0.1).to(torch.int32),
            w_main[1],
        ),
        (
            torch.randint(0, 4, (77, 33), device=dev, generator=gen, dtype=torch.int32),
            torch.randint(-500, 500, (33, 19), device=dev, generator=gen, dtype=torch.int32),
        ),
        (
            torch.full((5, 16), 3, dtype=torch.int32, device=dev),
            torch.full((16, 8), 2**27, dtype=torch.int32, device=dev),
        ),
    ]
    for s, w in cases:
        got, want = spike_matmul(s, w), spike_matmul_plain(s, w)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        check(torch.equal(got, want), f"spike_matmul {tuple(s.shape)}x{tuple(w.shape)} != plain")
    check(int(spike_matmul(*cases[3])[0, 0]) == -(2**31), "spike_matmul wraparound")
    s, w = cases[0]
    M, K = s.shape
    N = w.shape[1]
    s8, w8 = s.to(torch.int8), w.to(torch.int8)
    check(torch.equal(torch._int_mm(s8, w8), spike_matmul(s, w)), "library _int_mm != kernel")
    rate = INT8_TC_OPS_S if fits_int8(s, w) else INT32_OPS_S
    b_ms, b_by = bound(4 * (M * K + K * N + M * N), 2 * M * K * N, rate)
    return dict(
        name="spike_matmul",
        shape=f"[{M},{K}]x[{K},{N}] int32",
        replaces="src/repro/kernels/quant_matmul/spike_matmul.py:47",
        max_abs_err=err,
        ms=time_ms(lambda: spike_matmul(s, w)),
        plain_ms=time_ms(lambda: spike_matmul_plain(s, w), reps=5, inner=2),
        library_ms=time_ms(lambda: torch._int_mm(s8, w8)),
        bound_ms=b_ms,
        bound_by=b_by,
    )


def check_lif_scan(gen) -> dict:
    err = 0
    shapes = [(25, 1024, 128), (25, 1024, 10)]
    modes = [(243, False), (256, False), (243, True), (256, True)]  # LIF/IF x subtract/zero
    currents = {}
    for T, B, N in shapes:
        cur = torch.randint(-300, 400, (T, B, N), device=DEVICE, generator=gen, dtype=torch.int32)
        currents[N] = cur
        for k, zero in modes:
            s1, u1 = lif_scan(cur, theta_q=496, decay_k=k, u_bits=16, reset_to_zero=zero)
            s2, u2 = lif_scan_ref(cur, 496, k, 16, zero)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(s1, s2), max_abs_err(u1, u2))
            check(torch.equal(s1, s2) and torch.equal(u1, u2), f"lif_scan {T},{B},{N} k={k}")
    cur = currents[128]
    T, B, N = cur.shape
    taps = bin(243).count("1")
    b_ms, b_by = bound(4 * (2 * T * B * N + B * N), T * B * N * (12 + 2 * taps), INT32_OPS_S)
    kw = dict(theta_q=496, decay_k=243, u_bits=16, reset_to_zero=False)
    return dict(
        name="lif_scan",
        shape=f"[{T},{B},{N}] int32, LIF k=243",
        replaces="src/repro/kernels/lif_scan/lif_scan.py:64",
        max_abs_err=err,
        ms=time_ms(lambda: lif_scan(cur, **kw)),
        plain_ms=time_ms(lambda: lif_scan_ref(cur, 496, 243, 16, False), reps=5, inner=2),
        library_ms=None,
        bound_ms=b_ms,
        bound_by=b_by,
    )


def check_sparse_accum(gen, w0) -> dict:
    E, n_in = 32 * 64, 256
    budget = BINARY_SERVE_BUDGET
    binary = (torch.rand(E, n_in, device=DEVICE, generator=gen) < 0.10).to(torch.int32)
    levels = torch.randint(1, 40, (E, n_in), device=DEVICE, generator=gen, dtype=torch.int32)
    graded = binary * levels
    over = (torch.rand(E, n_in, device=DEVICE, generator=gen) < 0.40).to(torch.int32)
    err = 0
    for name, raster in (("binary", binary), ("graded", graded), ("over-budget", over)):
        vals, idx = fixed_capacity_events(raster, budget)
        got, want = sparse_accum(vals, idx, w0), sparse_accum_ref(vals, idx, w0)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        check(torch.equal(got, want), f"sparse_accum {name} != plain")
    check(int((binary != 0).sum(-1).max()) <= budget, "binary rows fit the budget")
    vals, idx = fixed_capacity_events(binary, budget)
    check(torch.equal(sparse_accum(vals, idx, w0), spike_matmul(binary, w0)), "sparse != dense")
    fw, fv, li = w0.to(torch.float32), vals.to(torch.float32), idx.to(torch.int64)
    lib = lambda: torch.nn.functional.embedding_bag(li, fw, per_sample_weights=fv, mode="sum")
    same = torch.equal(lib().to(torch.int32), sparse_accum(vals, idx, w0))
    check(same, "embedding_bag != kernel")
    N = w0.shape[1]
    nnz = int((vals != 0).sum())
    b_ms, b_by = bound(4 * (2 * E * budget + n_in * N + E * N), 2 * nnz * N, INT32_OPS_S)
    return dict(
        name="sparse_accum",
        shape=f"E={E} K={budget} [{n_in},{N}] int32, {nnz} events",
        replaces="src/repro/kernels/sparse_accum/sparse_accum.py:54",
        max_abs_err=err,
        ms=time_ms(lambda: sparse_accum(vals, idx, w0)),
        plain_ms=time_ms(lambda: sparse_accum_ref(vals, idx, w0), reps=5, inner=2),
        library_ms=time_ms(lib),
        bound_ms=b_ms,
        bound_by=b_by,
    )


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------


def assert_records_equal(a, b, what: str) -> None:
    check(torch.equal(a.spike_counts, b.spike_counts), f"{what}: spike_counts")
    check(len(a.layer_spikes) == len(b.layer_spikes), f"{what}: layer count")
    for x, y in zip(a.layer_spikes, b.layer_spikes):
        check(torch.equal(x, y), f"{what}: layer_spikes")
    check(torch.equal(a.input_events, b.input_events), f"{what}: input_events")


def phase_run_int(net, qparams, qparams_cpu) -> dict:
    ds = mnist_like(n=1024, T=25, seed=1)
    x = raster_tensor(ds.spikes.transpose(1, 0, 2), DEVICE)
    recs = {
        name: run_int(net, qparams, x, backend=b)
        for name, b in [
            ("reference", "reference"),
            ("fused", "fused"),
            ("event-pallas", EventBackend(strategy="pallas")),
        ]
    }
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ref = recs["reference"]
    check(ref.spike_counts.shape == (len(ds.labels), net.n_classes), "spike_counts shape")
    for name in ("fused", "event-pallas"):
        assert_records_equal(recs[name], ref, f"run_int {name} vs reference")
    cpu = run_int(net, qparams_cpu, x[:, :32].cpu(), backend="reference")
    check(torch.equal(cpu.spike_counts, ref.spike_counts[:32].cpu()), "card vs CPU on 32 samples")
    totals = [int(s.sum()) for s in ref.layer_spikes]
    check(totals[0] > 0, "hidden layer is silent")
    print(
        f"run_int: 3 backends bit-identical on {list(x.shape)}; input events "
        f"{int(ref.input_events.sum())}, layer spikes {totals}; card == CPU on 32 samples"
    )
    return counts


def phase_eval_int(net, qparams) -> dict:
    ds = mnist_like(n=4096, T=25, seed=2)
    results = {}
    for name, backend in [("fused", "fused"), ("event-pallas", EventBackend(strategy="pallas"))]:
        t0 = time.perf_counter()
        acc, stats = eval_int(
            net, qparams, ds, batch_size=4096, return_stats=True, backend=backend
        )
        dt = time.perf_counter() - t0
        results[name] = (acc, stats)
        n = len(ds.labels)
        print(f"eval_int[{name}]: acc {acc:.6f}, {n / dt:.1f} samples/s on the card ({dt:.4f} s)")
    counts = kernels.launch_counts()
    (a0, s0), (a1, s1) = results.values()
    check(a0 == a1, "eval_int accuracy differs across backends")
    check(np.array_equal(s0["input_events_per_step"], s1["input_events_per_step"]), "input stats")
    for x, y in zip(s0["layer_events_per_step"], s1["layer_events_per_step"]):
        check(np.array_equal(x, y), "layer stats")
    mean_events = [float(e.mean()) for e in s0["layer_events_per_step"]]
    print(
        f"eval_int: fused == event-pallas; mean input events/step "
        f"{float(s0['input_events_per_step'].mean()):.4f}, layer events/step {mean_events}"
    )
    return counts


def serving_traffic(n_in: int) -> list[SNNRequest]:
    """256 ragged requests, admitted in this order: 80 sparse (~3%, the
    event-pallas route: a pool of only these runs sparse ticks), 160 dense
    mnist-like (more active channels a step than the budget: f32_exact
    ticks), 16 dense graded with values above the f32 certificate (int32
    ticks)."""
    rng = np.random.default_rng(7)
    dense_ds = mnist_like(n=160, T=25, seed=3, max_rate=0.6)
    reqs = []
    for _ in range(80):
        T = int(rng.integers(8, 26))
        reqs.append((rng.random((T, n_in)) < 0.03).astype(np.uint8))
    for i in range(160):
        reqs.append(dense_ds.spikes[i, : int(rng.integers(8, 26))])
    for _ in range(16):
        T = int(rng.integers(8, 26))
        on = rng.random((T, n_in)) < 0.35
        reqs.append(np.where(on, rng.integers(1, 4000, (T, n_in)), 0).astype(np.int32))
    return [SNNRequest(uid=i, raster=r) for i, r in enumerate(reqs)]


def phase_serve(net, qparams) -> dict:
    engine = SNNServeEngine(
        net, qparams, max_batch=64, backend=EventBackend(strategy="pallas"), device=DEVICE
    )
    check(engine._event_budget == BINARY_SERVE_BUDGET, "serving event budget")
    engine.warmup(include_int32=True)
    reqs = serving_traffic(net.n_in)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(len(done) == len(reqs) and all(r.status == "completed" for r in done), "all served")
    hidden_events = sum(float(r.event_stats["layer_events_per_step"][0].sum()) for r in done)
    check(hidden_events > 0, "the hidden layer never fired while serving")
    snap = engine.metrics.snapshot()
    counters = snap["counters"]
    for r in done:
        x = torch.from_numpy(r.raster.astype(np.int32)[:, None, :]).to(DEVICE)
        rec = run_int(net, qparams, x, backend="reference")
        same = np.array_equal(r.spike_counts, rec.spike_counts[0].cpu().numpy())
        for got, want in zip(r.event_stats["layer_events_per_step"], rec.layer_spikes):
            same = same and np.array_equal(got, want[:, 0].cpu().numpy())
        check(same, f"request {r.uid} ({r.route}) differs from serial run_int")
    routes = {k[6:]: v for k, v in counters.items() if k.startswith("route:")}
    ticks = {k[5:]: v for k, v in counters.items() if k.startswith("tick:")}
    for mode in ("sparse", "f32_exact", "int32"):
        check(ticks.get(mode, 0) > 0, f"no {mode} tick was served")
    lat = snap["latency"]["all"]
    print(
        f"serve: {len(done)} requests bit-exact with serial run_int; routes {routes}; "
        f"ticks {ticks}; hidden-layer events {hidden_events:.0f}; "
        f"p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms; "
        f"{len(done) / wall:.1f} samples/s ({wall:.3f} s)"
    )
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False  # the certified f32 lowering needs full f32
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    nvcc_s = build.load_all()
    print(
        f"build: {nvcc_s:.2f} s nvcc ({len(build.KERNELS)} sources in parallel), "
        f"{time.perf_counter() - t0:.2f} s to load; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}"
    )

    net = NetworkConfig(
        layers=(
            LayerConfig(n_in=256, n_out=128, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
            LayerConfig(n_in=128, n_out=10, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
        ),
        n_steps=25,
        name="mnist-256-128-10",
    )
    params_cpu = init_float_params(torch.Generator().manual_seed(0), net, device="cpu")
    params = init_float_params(torch.Generator().manual_seed(0), net)
    qparams_cpu, _ = quantize_params(net, params_cpu)
    qparams, scales = quantize_params(net, params)
    for a, b in zip(qparams, qparams_cpu):
        check(all(torch.equal(x.cpu(), y) for x, y in zip(a, b)), "quantize_params card vs CPU")
    print(
        f"model: {net.name} LIF w6/u16 T=25, scales {scales}, "
        f"theta_q {[int(p.theta_q) for p in qparams]}"
    )

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = [
        check_spike_matmul(gen, [p.w_ff for p in qparams]),
        check_lif_scan(gen),
        check_sparse_accum(gen, qparams[0].w_ff),
    ]
    for r in rows:
        print(
            f"kernel {r['name']} {r['shape']}: bit-identical to plain (max_abs_err "
            f"{r['max_abs_err']}); {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
        )

    launches = dict.fromkeys(build.KERNELS, 0)
    for name, phase in [
        ("run_int", lambda: phase_run_int(net, qparams, qparams_cpu)),
        ("eval_int", lambda: phase_eval_int(net, qparams)),
        ("serve", lambda: phase_serve(net, qparams)),
    ]:
        # each phase reads the counts right after driving the main path,
        # before its own checks launch anything
        kernels.reset_launch_counts()
        counts = phase()
        print(f"launches[{name}]: {counts}")
        for k, v in counts.items():
            launches[k] += v
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was never launched on the main path")

    line = {
        "kernels": [
            {
                "name": r["name"],
                "route": "cuda",
                "source": f"src/repro_torch/csrc/{r['name']}.cu",
                "replaces": r["replaces"],
                "launches": launches[r["name"]],
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
            }
            for r in rows
        ]
    }
    print(json.dumps(line))
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
