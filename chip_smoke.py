#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its own line; any failure exits non-zero before the
result line):

1. the card (``nvidia-smi`` name and power limit) and the nvcc build of the
   five CUDA kernels from ``src/repro_torch/csrc``;
2. each kernel against its plain PyTorch version on the card at the main
   path's shapes -- the three SNN kernels bit for bit (``spike_matmul`` at
   its four main-path shapes, on a mixed raster, a graded serving tick and
   the 2^27 wraparound, and under the CUDA cores' int32 floor at
   [25600,256]x[256,128], which only its tensor-core route can reach;
   ``sparse_accum`` on binary, graded, over-budget and unsorted lists, timed
   at E = 2048 and 25600 beside the event encoder), ``quant_matmul``
   (int8 and int4) to the bf16 tolerance of ``tests/test_kernels.py``,
   ``flash_attention`` to one bf16 ulp (and in f32 to 1e-4), with planted
   faults shown to fail that tolerance, the two tensor-core kernels shown to
   give identical bits across launches and ``quant_matmul``'s rows not to
   depend on M -- timed (device time per call, torch.profiler) beside its
   plain version, a PyTorch library call where one computes the same function,
   and its roofline bound, with the achieved rate and share of the bound;
3. ``run_int`` of the 256-128-10 LIF network (w6/u16, T=25, random weights
   from a seeded generator) on a ``mnist_like`` batch of 1024 through the
   ``reference``, ``fused`` and ``event`` (pallas strategy) backends: every
   record field identical, and identical to the CPU on a slice;
4. ``eval_int`` on ``mnist_like(n=4096, T=25)`` at batch 4096 through
   ``fused`` and ``event``: equal accuracy and event statistics, then each
   batch's wall and device-busy time under torch.profiler;
5. ``SNNServeEngine`` (64 lanes, pallas event backend) on 256 ragged
   requests -- sparse, dense and graded -- each bit-exact with a serial
   ``run_int(reference)`` of its own raster;
6. LM decode serving at full width: stablelm-1.6b (24 layers, d_model 2048,
   random weights from a seeded generator, int8 block weights) in
   ``ServeEngine(max_batch=8, max_len=256)`` on 16 requests, two of them with
   one prompt (identical tokens required), then a short int4 pass;
   ``quant_matmul`` launches = 24 x 7 x decode steps; sampled requests'
   logits against a serial decode of their prompt alone;
7. one-pass ``prefill`` of 4096 tokens at full width (int8): 24
   ``flash_attention`` and 168 ``quant_matmul`` launches, and its caches at
   positions [0, 256) against a separate ``prefill`` of the first 256 tokens
   (plain ``attend``), a check that faults planted in the flash kernel's
   arguments (no causal mask, a 2x scale) must fail;
8. the card against the CPU at full width and 2 layers: one ``decode_step``
   of 2 slots and one ``prefill`` of 4096 tokens (the CPU runs the plain
   versions);
9. the Flex-plorer DSE at full width (benchmarks/dse_bench.py's 256-128-10
   LIF network, ATA-F hidden layer, T = 20, 1800 configurations), trained
   on the card as dse_bench trains it (``train_snn``, 6 epochs): a search on
   seeded random weights for comparison, then ``explore_snn`` NSGA-II
   (population 64, 3 generations, perf and bandwidth terms on) on the
   trained weights, its population sweep through ``spike_matmul`` and
   ``lif_scan``; every scored candidate's accuracy and stats equal to
   serial ``eval_int(reference)``; a repeated search and a search killed
   after generation 1 and resumed give the identical result; 4 candidates x
   32 samples card == CPU; the candidate-axis ``lif_scan`` bit-identical to
   its plain version at [64, 20, 231, 10]; the sweep's candidates/s at P =
   64 and 512 with its device-busy share, the profiler's launches by kernel
   equal to the wrappers' counts; then the search with its QAT refine phase
   (``RefineSpec(top_k=4)``): every refined candidate's PTQ and refined
   accuracy equal to serial ``eval_int(reference)``, best >= base, and the
   candidate-axis train step's ``spike_matmul`` launches = T x layers at K
   = 4 and K = 1, each bit-identical to plain;
10. training at full width (examples/quickstart.py: 256-128-10 LIF w6/u8,
   T = 25, 8 epochs): ``train_snn`` on the card, the trained net deployed
   through ``quantize_params`` -> ``eval_int`` on ``reference``, ``fused``
   and ``event`` (identical accuracies, above a floor), one train step on
   the card against the CPU, and a QAT epoch (``PrecisionConfig(w_bits=3)``)
   whose ``eval_qat`` equals ``eval_int`` of its deployment and whose every
   step launches ``spike_matmul`` T x layers times, each launch bit-identical
   to plain; train-, QAT- and refine-step times with their device-busy share;
11. the serving front end and crash safety on the phases 3-5 net
   (``SNNServeEngine(max_batch=64, backend=EventBackend("pallas"),
   tick_stride=16)``): 256 streaming sessions x 64 steps in 16-step chunks,
   fed in three groups one after the other (96 sparse, 128 dense
   ``mnist_like``, 32 graded) so that sparse, f32_exact and int32 ticks
   all occur, every readout equal to the prefix counts of a serial
   ``run_int(reference)``, with steps/s, chunks/s, chunk p50/p99 and one
   round's device-busy share; the same streams with every session evicted
   to ``build/phase11/`` after each round (identical readouts, evictions =
   restores + 256); phase 5's traffic without and with a ``Journal``
   (results equal to phase 5's); a ``SupervisedEngine`` with a journal and
   a checkpoint store serving 64 requests and 16 streams through a slow
   tick, a tick raise, a poisoned carry and a kill, every result bit-exact
   and the recovery counters equal to what was armed; ``SNNHttpServer``'s
   routes on 127.0.0.1; ``launch/serve_snn.main`` in replay and
   ``--streaming 16`` modes.  Phases 5 and 11 print dispatch against tick
   wall from the engine's own timers;
12. a ``kernels`` JSON line (launches on phases 3-7 and 9-11, times,
   bounds); phases 3-5 and 9-11 also print the SNN kernels' launches by
   size;
13. the result line.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import io
import itertools
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.core import backend as backend_mod  # noqa: E402
from repro_torch.core.backend import (  # noqa: E402
    EventBackend,
    run_int_population,
    stack_population,
)
from repro_torch.core.flexplorer import explorer as explorer_mod  # noqa: E402
from repro_torch.core.flexplorer.cost import CostWeights  # noqa: E402
from repro_torch.core.flexplorer.explorer import (  # noqa: E402
    EvalSpec,
    RefineSpec,
    SearchSpec,
    SNNSearchSpace,
    explore_snn,
)
from repro_torch.core.flexplorer.strategies import NSGAConfig  # noqa: E402
from repro_torch.core.precision import (  # noqa: E402
    PrecisionPolicy,
    QTensor,
    dequantize_weight,
    quantize_tree,
    quantize_weight,
    tree_map,
)
from repro_torch.core.network import (  # noqa: E402
    NetworkConfig,
    init_float_params,
    quantize_params,
    run_int,
)
from repro_torch.core import snn_layer as snn_layer_mod  # noqa: E402
from repro_torch.core.snn_layer import (  # noqa: E402
    FloatLayerParams,
    IntLayerParams,
    LayerConfig,
    NeuronModel,
    Topology,
)
from repro_torch.data.snn_datasets import SpikeDataset, mnist_like, raster_tensor  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attend  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.lif_scan.lif_scan import lif_scan  # noqa: E402
from repro_torch.kernels.lif_scan.ref import lif_scan_ref  # noqa: E402
from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref  # noqa: E402
from repro_torch.kernels.quant_matmul.spike_matmul import (  # noqa: E402
    plan,
    spike_matmul,
    spike_matmul_plain,
)
from repro_torch.kernels.sparse_accum.ops import fixed_capacity_events  # noqa: E402
from repro_torch.kernels.sparse_accum.ref import sparse_accum_ref  # noqa: E402
from repro_torch.kernels.sparse_accum.sparse_accum import sparse_accum  # noqa: E402
from repro_torch.launch import serve_snn  # noqa: E402
from repro_torch.launch.serve import QUANT_RULES  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import AttnMask, attend  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.registry import get_arch  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.faults import FaultInjector  # noqa: E402
from repro_torch.serve.http import SNNHttpServer  # noqa: E402
from repro_torch.serve.journal import Journal, read_records, recover  # noqa: E402
from repro_torch.serve.snn_engine import AsyncSNNServer, SNNRequest, SNNServeEngine  # noqa: E402
from repro_torch.serve.streaming import (  # noqa: E402
    AsyncStreamServer,
    StreamConfig,
    StreamSessionManager,
)
from repro_torch.serve.supervisor import SupervisedEngine  # noqa: E402
from repro_torch.snn.qat import (  # noqa: E402
    PrecisionConfig,
    candidate_grid,
    eval_qat,
    refine_step,
    run_qat,
)
from repro_torch.snn.surrogate import fast_sigmoid  # noqa: E402
from repro_torch.snn.train import eval_int, eval_int_population, train_snn  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.optimizer import adamw, linear_warmup_cosine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper, dense, 700 W).
HBM_BYTES_S = 3.35e12
INT8_TC_OPS_S = 1979e12  # int8 tensor cores
INT32_OPS_S = 33.5e12  # int32 on the CUDA cores
BF16_TC_FLOPS = 989e12  # bf16 tensor cores
L2_BYTES = 50 * 2**20
BINARY_SERVE_BUDGET = 64  # EventBackend().serve_budget(256, 0.10)
DEVICE = "cuda"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def stream_ms(fn, reps: int = 15, inner: int = 10, warmup: int = 3) -> float:
    """Median milliseconds per call over ``reps`` CUDA-event windows of
    ``inner`` back-to-back calls: device time plus any gap the host leaves
    between launches."""
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


def time_ms(fn, reps: int = 15, inner: int = 10, warmup: int = 3) -> float:
    """Device milliseconds per call: the time the card spent in ``fn``'s
    kernels and copies (torch.profiler) over ``reps * inner`` calls, divided
    by the calls.  Host time between launches is left out -- at decode shapes
    a kernel runs for less time than its Python wrapper takes to launch it.
    Falls back to :func:`stream_ms` if the profiler sees no device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps * inner):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return us / 1e3 / (reps * inner) if us > 0 else stream_ms(fn, reps, inner, 0)


def bound(n_bytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bits16(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor's bit patterns, so that equality means identical bits."""
    return t.view(torch.int16)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def fits_int8(*ts) -> bool:
    return all(int(t.min()) >= -128 and int(t.max()) <= 127 for t in ts)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def share(bound_ms: float, ms: float) -> str:
    return f"{bound_ms / ms:.4f}"


# spike_matmul's (M, K, N) on the main path: the reference backend's
# per-step product (B = 1024), the fused window of phases 3-4 (T = 25 x B =
# 1024 and 4096) for each layer (256 -> 128, 128 -> 10)
SPIKE_SHAPES = [(1024, 256, 128), (25600, 256, 128), (102400, 256, 128), (25600, 128, 10)]
# the int32 CUDA cores' floor for [25600,256]x[256,128]: 2 M K N / 33.5 TOP/s
SPIKE_INT32_FLOOR_MS = 2 * 25600 * 256 * 128 / INT32_OPS_S * 1e3


def mixed_raster(gen, M: int, K: int) -> torch.Tensor:
    """Binary spikes (rate 0.12) with a graded value of 128..3999 in 8 of
    the 16-row strips, which sends those strips' chunk to byte planes."""
    s = (torch.rand(M, K, device=DEVICE, generator=gen) < 0.12).to(torch.int32)
    strips = torch.randperm(M // 16, device=DEVICE, generator=gen)[:8]
    for i, strip in enumerate(strips.tolist()):
        s[16 * strip + i % 16, (37 * i) % K] = 128 + 483 * i
    return s


def check_spike_matmul(gen, w_main) -> dict:
    """Bit for bit against plain at every main-path shape (binary x w6, one
    int8 tensor-core pass), on a mixed raster and a graded serving tick (byte
    planes), a ragged graded case with wide weights and the 2^27 wraparound
    (CUDA cores); each main-path shape timed beside ``torch._int_mm`` and its
    bound."""
    dev = DEVICE
    w_of = {w.shape: w for w in w_main}
    main = {
        (M, K, N): (torch.rand(M, K, device=dev, generator=gen) < 0.12).to(torch.int32)
        for M, K, N in SPIKE_SHAPES
    }
    mixed = mixed_raster(gen, 25600, 256)
    cases = [(s, w_of[(K, N)]) for (M, K, N), s in main.items()] + [
        (mixed, w_of[(256, 128)]),
        (
            torch.randint(0, 4, (77, 33), device=dev, generator=gen, dtype=torch.int32),
            torch.randint(-500, 500, (33, 19), device=dev, generator=gen, dtype=torch.int32),
        ),
        (
            torch.full((5, 16), 3, dtype=torch.int32, device=dev),
            torch.full((16, 8), 2**27, dtype=torch.int32, device=dev),
        ),
    ]
    err = 0
    for s, w in cases:
        got, want = spike_matmul(s, w), spike_matmul_plain(s, w)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        check(torch.equal(got, want), f"spike_matmul {tuple(s.shape)}x{tuple(w.shape)} != plain")
    check(int(spike_matmul(*cases[-1])[0, 0]) == -(2**31), "spike_matmul wraparound")
    check(not fits_int8(mixed), "the mixed raster holds values above int8")
    rows = {}
    for (M, K, N), s in main.items():
        w = w_of[(K, N)]
        check(fits_int8(s, w), f"[{M},{K}]x[{K},{N}]: binary x w6 fits int8")
        s8, w8 = s.to(torch.int8), w.to(torch.int8)
        lib = None
        if N % 8 == 0:  # torch._int_mm takes N % 8 == 0 only
            check(torch.equal(torch._int_mm(s8, w8), spike_matmul(s, w)), "_int_mm != kernel")
            lib = time_ms(lambda: torch._int_mm(s8, w8))
        b_ms, b_by = bound(4 * (M * K + K * N + M * N), 2 * M * K * N, INT8_TC_OPS_S)
        r = rows[(M, K, N)] = dict(
            ms=time_ms(lambda: spike_matmul(s, w)), library_ms=lib, bound_ms=b_ms, bound_by=b_by
        )
        print(
            f"kernel spike_matmul [{M},{K}]x[{K},{N}] binary x w6: {r['ms']:.5f} ms, "
            f"{4 * (M * K + K * N + M * N) / r['ms'] / 1e6:.1f} GB/s, "
            f"{share(b_ms, r['ms'])} of the bound {b_ms:.5f} ms ({b_by}); library "
            + (f"{lib:.5f} ms (torch._int_mm, int8)" if lib is not None else "none (N % 8 != 0)")
        )
    w = w_of[(256, 128)]
    mixed_ms = time_ms(lambda: spike_matmul(mixed, w))
    print(
        f"kernel spike_matmul [25600,256]x[256,128] mixed raster (8 strips with graded values in "
        f"byte planes, the rest in one int8 pass): bit-identical to plain, {mixed_ms:.5f} ms"
    )
    # phase 5's int32 serving ticks: 64 lanes of graded values up to 3999,
    # every strip in byte planes
    graded = torch.randint(0, 4000, (64, 256), device=dev, generator=gen, dtype=torch.int32)
    graded *= (torch.rand(64, 256, device=dev, generator=gen) < 0.35).to(torch.int32)
    same = torch.equal(spike_matmul(graded, w), spike_matmul_plain(graded, w))
    check(same, "spike_matmul graded tick != plain")
    print(
        f"kernel spike_matmul [64,256]x[256,128] graded (an int32 serving tick, byte planes): "
        f"bit-identical to plain, {time_ms(lambda: spike_matmul(graded, w)):.5f} ms"
    )
    key = (25600, 256, 128)
    r = rows[key]
    check(
        r["ms"] < SPIKE_INT32_FLOOR_MS,
        f"spike_matmul {key}: {r['ms']:.5f} ms is not under the CUDA cores' int32 floor "
        f"{SPIKE_INT32_FLOOR_MS:.5f} ms, so the tensor-core route was not taken",
    )
    s = main[key]
    return dict(
        name="spike_matmul",
        shape="[25600,256]x[256,128] int32, binary x w6",
        replaces="src/repro/kernels/quant_matmul/spike_matmul.py:47",
        max_abs_err=err,
        ms=r["ms"],
        plain_ms=time_ms(lambda: spike_matmul_plain(s, w), reps=5, inner=2),
        library_ms=r["library_ms"],
        bound_ms=r["bound_ms"],
        bound_by=r["bound_by"],
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
    # the kernel alone: theta and the register already on the card, as the
    # population sweep passes them (a single window is the case P = 1)
    regs = [torch.tensor([v], dtype=torch.int32, device=DEVICE) for v in (496, 243)]
    kw = dict(theta_q=regs[0], decay_k=regs[1], u_bits=16, reset_to_zero=False)
    ms = time_ms(lambda: lif_scan(cur[None], **kw))
    # the scalar call as FusedBackend makes it (theta a device scalar, the
    # register an int): the kernel and the fill of the register
    kw_fused = dict(theta_q=regs[0][0], decay_k=243, u_bits=16, reset_to_zero=False)
    print(
        f"lif_scan [{T},{B},{N}] scalar call (theta a device scalar, register an int): "
        f"{time_ms(lambda: lif_scan(cur, **kw_fused)):.5f} ms device, "
        f"{stream_ms(lambda: lif_scan(cur, **kw_fused)):.5f} ms per call back to back; "
        f"the kernel alone {ms:.5f} ms"
    )
    return dict(
        name="lif_scan",
        shape=f"[{T},{B},{N}] int32, LIF k=243",
        replaces="src/repro/kernels/lif_scan/lif_scan.py:64",
        max_abs_err=err,
        ms=ms,
        plain_ms=time_ms(lambda: lif_scan_ref(cur, 496, 243, 16, False), reps=5, inner=2),
        library_ms=None,
        bound_ms=b_ms,
        bound_by=b_by,
    )


def phase3_events() -> tuple[torch.Tensor, int]:
    """Layer 0's input raster of phase 3 (mnist_like, 1024 samples x T = 25,
    flattened to [25600, 256]) and the event budget the pallas event backend
    measures for it."""
    ds = mnist_like(n=1024, T=25, seed=1)
    flat = raster_tensor(ds.spikes.transpose(1, 0, 2), DEVICE).reshape(-1, ds.spikes.shape[2])
    k_max = int((flat != 0).sum(-1).max())
    return flat, EventBackend(strategy="pallas").static_budget(flat.shape[1], k_max=k_max)


def check_sparse_accum(gen, w0) -> dict:
    """Bit for bit against plain and the dense product on binary, graded,
    over-budget and unsorted event lists at the serving shape (E = 2048);
    timed there and at phase 3's E = 25600 beside ``embedding_bag`` and the
    bound, with the encoder's time beside it at E = 2048."""
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
    # the same events in each row's slots shuffled: zeros between events
    vals, idx = fixed_capacity_events(graded, budget)
    perm = torch.rand(E, budget, device=DEVICE, generator=gen).argsort(dim=1)
    sv, si = vals.gather(1, perm).contiguous(), idx.gather(1, perm).contiguous()
    got = sparse_accum(sv, si, w0)
    check(torch.equal(got, sparse_accum_ref(sv, si, w0)), "sparse_accum unsorted != plain")
    check(torch.equal(got, spike_matmul(graded, w0)), "sparse_accum unsorted != dense")
    vals, idx = fixed_capacity_events(binary, budget)
    check(torch.equal(sparse_accum(vals, idx, w0), spike_matmul(binary, w0)), "sparse != dense")

    flat, budget3 = phase3_events()
    v3, i3 = fixed_capacity_events(flat, budget3)
    check(torch.equal(sparse_accum(v3, i3, w0), spike_matmul(flat, w0)), "phase-3 events != dense")
    N = w0.shape[1]
    rows = {}
    for (vals, idx) in ((vals, idx), (v3, i3)):
        Ex, K = vals.shape
        fw, fv, li = w0.to(torch.float32), vals.to(torch.float32), idx.to(torch.int64)
        lib = lambda: torch.nn.functional.embedding_bag(li, fw, per_sample_weights=fv, mode="sum")
        same = torch.equal(lib().to(torch.int32), sparse_accum(vals, idx, w0))
        check(same, "embedding_bag != kernel")
        nnz = int((vals != 0).sum())
        b_ms, b_by = bound(4 * (2 * Ex * K + n_in * N + Ex * N), 2 * nnz * N, INT32_OPS_S)
        r = rows[Ex] = dict(
            shape=f"E={Ex} K={K} [{n_in},{N}] int32, {nnz} events",
            ms=time_ms(lambda: sparse_accum(vals, idx, w0)),
            library_ms=time_ms(lib),
            bound_ms=b_ms,
            bound_by=b_by,
        )
        print(
            f"kernel sparse_accum {r['shape']}: {r['ms']:.5f} ms, {share(b_ms, r['ms'])} of the "
            f"bound {b_ms:.5f} ms ({b_by}); library {r['library_ms']:.5f} ms (embedding_bag, f32)"
        )
    enc_ms = time_ms(lambda: fixed_capacity_events(binary, budget))
    print(
        f"sparse serving tick at E={E}: encoder fixed_capacity_events {enc_ms:.5f} ms + "
        f"sparse_accum {rows[E]['ms']:.5f} ms of device time"
    )
    vals, idx = fixed_capacity_events(binary, budget)
    return dict(
        name="sparse_accum",
        shape=rows[E]["shape"],
        replaces="src/repro/kernels/sparse_accum/sparse_accum.py:54",
        max_abs_err=err,
        ms=rows[E]["ms"],
        plain_ms=time_ms(lambda: sparse_accum_ref(vals, idx, w0), reps=5, inner=2),
        library_ms=rows[E]["library_ms"],
        bound_ms=rows[E]["bound_ms"],
        bound_by=rows[E]["bound_by"],
    )


# quant_matmul: the bf16 tolerance of tests/test_kernels.py -- the kernel
# accumulates in f32 in another K order than its plain version, and a
# near-tie lands up to 2 bf16 ulps apart after the final cast.
QM_TOL = dict(rtol=2**-7, atol=1e-5)
# flash_attention keeps scores, probabilities and the accumulator in f32 like
# its plain version, so bf16 outputs differ by at most one rounding of the
# final cast: one ulp, <= 2^-7 |want|.  The atol, for values near zero, is
# far below the typical |output| of a 4096-key causal row (~0.02), so
# near-zero or mis-weighted rows fail; each case also shows that planted
# faults fall outside it.  f32: the same math in another order.
FA_TOL = dict(rtol=2**-7, atol=2e-3)
FA_TOL_F32 = dict(rtol=1e-4, atol=1e-4)


def tol_used(got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 within the tolerance."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


def close(got: torch.Tensor, want: torch.Tensor, tol: dict, what: str) -> float:
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    used = tol_used(got, want, tol) if got.numel() else 0.0
    ok = used <= 1 and bool(torch.isfinite(got).all())
    check(ok, f"{what}: max_abs_err {err} ({used:.3f} of the tolerance {tol})")
    return err


# (count per layer, K, N) of the LM's quantized matmuls: wq wk wv wo, w_gate
# w_up, w_down of stablelm-1.6b (d_model 2048, d_ff 5632)
LM_QDOTS = [(4, 2048, 2048), (2, 2048, 5632), (1, 5632, 2048)]
QDOTS_PER_LAYER = sum(n for n, _, _ in LM_QDOTS)


def check_quant_matmul(gen, n_layers: int) -> dict:
    """int8 and int4 at every full-width shape of the LM path -- decode
    (M = max_batch = 8) and prefill (M = 4096) -- and one ragged shape; each
    main-path shape timed (decode shapes with weights cold in L2), and the
    kernel time of one decode step and of one prefill derived from those
    times and the launch counts."""
    dev = DEVICE
    shapes = [(M, K, N) for M in (8, 4096) for _, K, N in LM_QDOTS] + [(5, 96, 24)]
    err = 0.0
    cases = {}
    for bits in (8, 4):
        for M, K, N in shapes:
            w = torch.randn(K, N, device=dev, generator=gen) * K**-0.5
            x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            qt = quantize_weight(w, bits)
            got = quant_matmul(x, qt.q, qt.scale, bits=bits)
            want = quant_matmul_ref(x, qt.q, qt.scale, bits, torch.bfloat16)
            torch.cuda.synchronize()
            err = max(err, close(got, want, QM_TOL, f"quant_matmul int{bits} [{M},{K}]x[{K},{N}]"))
            cases[(bits, M, K, N)] = (x, qt)
    # the same call twice gives the same bits (no float atomics, a fixed
    # order of the split-K sum); a wide call's rows do not depend on M
    # (phase 7 needs it of the layer-0 K/V cache)
    for (bits, M, K, N), (x, qt) in cases.items():
        if M < 8:
            continue
        a, b = (quant_matmul(x, qt.q, qt.scale, bits=bits) for _ in range(2))
        shape = f"int{bits} [{M},{K}]x[{K},{N}]"
        check(torch.equal(bits16(a), bits16(b)), f"quant_matmul {shape}: two launches differ")
        if M == 4096:
            part = quant_matmul(x[:256].contiguous(), qt.q, qt.scale, bits=bits)
            same = torch.equal(bits16(part), bits16(a[:256]))
            check(same, f"quant_matmul {shape}: rows of M = 256 differ from M = 4096's")
    torch.cuda.synchronize()
    print(
        "quant_matmul: two launches bit-identical at the 6 main-path shapes, int8 and int4; "
        "at the 3 prefill shapes the rows of M = 256 equal the first 256 of M = 4096 bit for bit"
    )
    rows = {}
    for M, K, N in shapes[:-1]:
        x, qt = cases[(8, M, K, N)]
        x4, qt4 = cases[(4, M, K, N)]
        wd = dequantize_weight(qt, torch.bfloat16)  # the library call's weight, prepared beforehand
        reps = dict(reps=15, inner=10) if M <= 8 else dict(reps=7, inner=3)
        # a decode step reads each layer's weights once, so they come from
        # device memory, not L2: decode shapes cycle through copies of the
        # weights that together exceed twice the L2 (int4: half the bytes)
        n = 1 if M > 8 else -(-4 * L2_BYTES // (K * N))
        q8 = itertools.cycle([(qt.q.clone(), qt.scale.clone()) for _ in range(n)]).__next__
        q4 = itertools.cycle([(qt4.q.clone(), qt4.scale.clone()) for _ in range(n)]).__next__
        wds = itertools.cycle([wd.clone() for _ in range(n)]).__next__
        ops = 2 * M * K * N
        n_bytes = {b: 2 * M * K + K * N * b // 8 + 4 * N + 2 * M * N for b in (8, 4)}
        b_ms, b_by = bound(n_bytes[8], ops, BF16_TC_FLOPS)
        b4_ms, b4_by = bound(n_bytes[4], ops, BF16_TC_FLOPS)
        r = rows[(M, K, N)] = dict(
            stream_ms=stream_ms(lambda: quant_matmul(x, *q8(), bits=8), **reps),
            ms=time_ms(lambda: quant_matmul(x, *q8(), bits=8), **reps),
            int4_ms=time_ms(lambda: quant_matmul(x4, *q4(), bits=4), **reps),
            plain_ms=time_ms(lambda: quant_matmul_ref(x, *q8(), 8, torch.bfloat16), **reps),
            library_ms=time_ms(lambda: torch.matmul(x, wds()), **reps),
            bound_ms=b_ms,
            bound_by=b_by,
        )
        del q8, q4, wds

        def rate(ms, bits, by, b):
            if by == "bytes":
                got = f"{n_bytes[bits] / ms / 1e6:.1f} GB/s"
            else:
                got = f"{ops / ms / 1e9:.1f} TFLOP/s"
            return f"{got}, {b / ms:.4f} of the bound"

        print(
            f"kernel quant_matmul [{M},{K}]x[{K},{N}] bf16 x int8"
            f"{' (weights cold in L2)' * (n > 1)}: "
            f"{r['ms']:.5f} ms ({rate(r['ms'], 8, b_by, b_ms)}; {r['stream_ms']:.5f} ms a call "
            f"back to back on the stream, host gaps included) "
            f"(int4 {r['int4_ms']:.5f} ms: {rate(r['int4_ms'], 4, b4_by, b4_ms)}, bound "
            f"{b4_ms:.5f} ms), plain {r['plain_ms']:.5f} ms, library "
            f"{r['library_ms']:.5f} ms (bf16 matmul of the dequantized weight), bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})"
        )
    for M, what in ((8, "decode step"), (4096, "4096-token prefill")):
        per = {k: n_layers * sum(n * rows[(M, K, N)][k] for n, K, N in LM_QDOTS)
               for k in ("ms", "int4_ms", "library_ms", "bound_ms")}
        print(
            f"quant_matmul time of one {what} ({n_layers} layers x {QDOTS_PER_LAYER} launches, "
            f"from the times above): "
            f"int8 {per['ms']:.4f} ms, int4 {per['int4_ms']:.4f} ms, library "
            f"{per['library_ms']:.4f} ms, bound {per['bound_ms']:.4f} ms"
        )
    main = rows[(8, 2048, 5632)]  # a decode shape: the main path launches these most
    return dict(
        name="quant_matmul",
        shape="[8,2048]x[2048,5632] bf16 x int8 (decode); int8 and int4 checked at 7 shapes",
        replaces="src/repro/kernels/quant_matmul/quant_matmul.py:74",
        max_abs_err=err,
        **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
    )


def check_flash_attention(gen, n_layers: int) -> dict:
    """[1, 32, 4096, 64] causal (the full-width prefill) in bf16 and f32, a
    window + softcap case whose scores the cap bends, a ragged Sq = 300 case
    and a GQA case through ``flash_attend``; in each bf16 case the plain
    version with a planted fault must fall outside the tolerance."""
    dev = DEVICE
    mk = lambda *shape: torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)
    err = 0.0
    S = 4096
    cases = [
        # scores ~ N(0, 1)
        ((1, 32, S, 64), 1.0, dict(causal=True), dict(
            scale_x2=dict(causal=True, scale=2 / 8),
            keys_past_S_minus_64_dropped=dict(causal=True, window=S - 64),
            zero_output=None,
        )),
        # q x 8: scores ~ N(0, 64), where 30 tanh(s / 30) bends them
        ((1, 8, 1024, 64), 8.0, dict(causal=True, window=64, softcap=30.0), dict(
            no_softcap=dict(causal=True, window=64),
            no_window=dict(causal=True, softcap=30.0),
        )),
        ((2, 4, 300, 64), 1.0, dict(causal=True), dict(not_causal=dict(causal=False))),
    ]
    used = {}
    main = None
    for shape, q_mult, kw, faults in cases:
        q, k, v = (mk(*shape) * q_mult).to(torch.bfloat16), mk(*shape), mk(*shape)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        what = f"flash_attention {shape} {kw}"
        err = max(err, close(got, want, FA_TOL, what))
        used[what] = [tol_used(got, want, FA_TOL)]
        for fault, fkw in faults.items():
            wrong = torch.zeros_like(want) if fkw is None else flash_attention_ref(q, k, v, **fkw)
            used[what].append(tol_used(wrong, want, FA_TOL))
            check(used[what][-1] > 1, f"{what}: planted fault {fault} passes the tolerance")
        main = main or (q, k, v)
    q, k, v = main
    got32 = flash_attention(q.float(), k.float(), v.float(), causal=True)
    want32 = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    close(got32, want32, FA_TOL_F32, "flash_attention f32 [1,32,4096,64] causal")
    f32_used = tol_used(got32, want32, FA_TOL_F32)
    del got32, want32
    q, k, v = mk(1, 1024, 32, 64), mk(1, 1024, 8, 64), mk(1, 1024, 8, 64)  # [B, S, H, D]
    got = flash_attend(q, k, v, causal=True)
    want = attend(q, k, v, mask=AttnMask(causal=True))
    torch.cuda.synchronize()
    err = max(err, close(got, want, FA_TOL, "flash_attend GQA 32/8 heads"))
    # the classic GQA slip: query head h read from kv head h % 8, not h // 4
    wrong = attend(q, k.repeat(1, 1, 4, 1), v.repeat(1, 1, 4, 1), mask=AttnMask(causal=True))
    gqa = used["flash_attend GQA 32/8 heads"] = [tol_used(x, want, FA_TOL) for x in (got, wrong)]
    check(gqa[-1] > 1, "GQA: planted head map passes the tolerance")
    print(
        f"flash_attention checks, tolerance used by the kernel, then by each planted fault "
        f"(> 1 fails): {json.dumps({w: [round(u, 4) for u in x] for w, x in used.items()})}; "
        f"f32 [1,32,4096,64] causal within {FA_TOL_F32} ({f32_used:.4f} of it)"
    )

    q, k, v = main
    a, b = (flash_attention(q, k, v, causal=True) for _ in range(2))
    check(torch.equal(bits16(a), bits16(b)), "flash_attention [1,32,4096,64]: two launches differ")
    del a, b
    B, H, S, D = q.shape
    ops = 4 * B * H * D * (S * (S + 1) // 2)  # QK^T and PV over the causal pairs only
    b_ms, b_by = bound(4 * q.numel() * 2, ops, BF16_TC_FLOPS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = dict(
        name="flash_attention",
        shape=f"[{B},{H},{S},{D}] bf16 causal",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:77",
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention(q, k, v, causal=True), reps=7, inner=3),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, causal=True), reps=5, inner=2),
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True)),
        bound_ms=b_ms,
        bound_by=b_by,
    )
    print(
        f"flash_attention [1,32,4096,64] bf16 causal: two launches bit-identical; "
        f"{ops / row['ms'] / 1e9:.1f} TFLOP/s, {b_ms / row['ms']:.4f} of the bound; time of one "
        f"4096-token prefill ({n_layers} launches): "
        f"{n_layers * row['ms']:.4f} ms, library {n_layers * row['library_ms']:.4f} ms, "
        f"bound {n_layers * b_ms:.4f} ms"
    )
    return row


# ---------------------------------------------------------------------------
# Phases 3-5: the main path
# ---------------------------------------------------------------------------

# the sizes each SNN kernel is launched with, as its C entry point takes
# them (positions among its int arguments): spike_matmul (M, K, N, batch,
# s_batched, w_batched), sparse_accum (E, K, n_in, N), lif_scan (P, T, B*N)
TALLY_INTS = {
    "spike_matmul": (0, 1, 2, 6, 7, 8),
    "sparse_accum": (0, 1, 2, 3),
    "lif_scan": (0, 1, 2),
}
_SIZES = {"open": False, "tally": collections.Counter()}


@contextlib.contextmanager
def launch_sizes():
    """Count the SNN kernels' launches by size between :func:`reset_counts`
    and :func:`read_counts`: the wrappers look ``build.entry`` up at every
    call, so wrapping it sees each launch (their own counts are unchanged)."""
    real = build.entry

    def entry(name, symbol, n_pointers, n_ints, n_floats=0):
        fn = real(name, symbol, n_pointers, n_ints, n_floats)
        if name not in TALLY_INTS:
            return fn

        def launch(*args):
            if _SIZES["open"]:
                ints = args[n_pointers:]
                _SIZES["tally"][(name, tuple(ints[i] for i in TALLY_INTS[name]))] += 1
            return fn(*args)

        return launch

    with mock.patch.object(build, "entry", entry):
        yield _SIZES["tally"]
    _SIZES["open"] = False


def reset_counts() -> None:
    """Set every kernel's launch count to 0 and (re)start the size tally."""
    kernels.reset_launch_counts()
    _SIZES["tally"].clear()
    _SIZES["open"] = True


def read_counts() -> dict[str, int]:
    """The wrappers' launch counts; closes the size tally at the same moment,
    so both cover the same launches."""
    _SIZES["open"] = False
    return kernels.launch_counts()


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
    counts = read_counts()
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
    counts = read_counts()
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
    # where a 4096-sample batch's time goes (after the counts were read)
    for name, backend in [("fused", "fused"), ("event-pallas", EventBackend(strategy="pallas"))]:
        run = lambda: eval_int(net, qparams, ds, batch_size=4096, backend=backend)
        print(f"eval_int[{name}] batch split: {device_split(run, n=3)}")
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


def dispatch_vs_tick(engine, wall: float) -> str:
    """The engine's own timers: host scheduling (dispatch rounds) against
    the lane-window calls (tick wall, the device->host copy of the outputs
    included), beside the run's wall."""
    m = engine.metrics
    return (
        f"dispatch {m.dispatch_s:.4f} s, tick {m.tick_s:.4f} s over {m.n_ticks} ticks "
        f"({1e3 * m.tick_s / max(1, m.n_ticks):.3f} ms a tick), the rest "
        f"{wall - m.dispatch_s - m.tick_s:.4f} s of {wall:.4f} s wall"
    )


def phase_serve(net, qparams, results: dict) -> dict:
    """Serve :func:`serving_traffic`; ``results`` gets each request's spike
    counts by uid (phase 11 serves the same traffic through a journal)."""
    engine = SNNServeEngine(
        net, qparams, max_batch=64, backend=EventBackend(strategy="pallas"), device=DEVICE
    )
    check(engine._event_budget == BINARY_SERVE_BUDGET, "serving event budget")
    engine.warmup(include_int32=True)
    reqs = serving_traffic(net.n_in)
    reset_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(len(done) == len(reqs) and all(r.status == "completed" for r in done), "all served")
    results.update((r.uid, r.spike_counts) for r in done)
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
    print(f"serve: {dispatch_vs_tick(engine, wall)}")
    return counts


# ---------------------------------------------------------------------------
# Phases 6-8: LM serving at full width
# ---------------------------------------------------------------------------

LM_ARCH = "stablelm-1.6b"


def lm_policy(bits: int) -> PrecisionPolicy:
    return PrecisionPolicy(rules=((QUANT_RULES[0], bits),))


def lm_requests(n: int, max_new: int, vocab: int) -> list[Request]:
    """Prompts of 4-32 tokens over the full vocab; request 9 repeats request
    0's prompt, so with 8 slots the two land in different waves."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, int(rng.integers(4, 33))) for _ in range(n)]
    if n > 9:
        prompts[9] = prompts[0].copy()
    return [Request(uid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]


def device_split(fn, n: int = 5) -> str:
    """Wall vs device-busy time of ``n`` calls of ``fn`` under torch.profiler,
    and the kernels that took the most device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    # device-side entries only (kernels, copies), so no time is counted twice
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    if not events:
        return f"wall {wall_ms:.3f} ms per call; device time not measured (the profiler saw none)"
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    names = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.3f} ms" for e in top)
    return (
        f"wall {wall_ms:.3f} ms per call (under the profiler), device busy {busy_ms:.3f} ms "
        f"({100 * (1 - busy_ms / wall_ms):.1f} % idle); top kernels per call: {names}"
    )


# a request's logits, served in a batch, against a serial decode of its
# prompt alone: both run every operation at the same shapes, row for row, so
# the rows should agree to float reordering at most; 1e-3 of max |logit|
# must lie below what another prompt's row differs by (checked and printed)
SERIAL_TOL = 1e-3
SERIAL_UIDS = (0, 5, 9, 13)  # request 9 repeats request 0's prompt


def record_logits(engine: ServeEngine, uids) -> tuple[dict, dict]:
    """Wrap ``engine``'s decode step, admission and tick so that each request
    in ``uids`` keeps its slot and the logits row that chose each of its
    generated tokens (a device copy per token)."""
    rows, slot_of, last = {u: [] for u in uids}, {}, {}
    decode, admit, tick = engine._decode, engine.admit, engine.tick

    def _decode(tokens):
        last["logits"] = decode(tokens)
        return last["logits"]

    def _admit(req):
        ok = admit(req)
        if ok and req.uid in rows:
            slot_of[req.uid] = next(i for i, r in enumerate(engine.slots) if r is req)
            rows[req.uid].append(last["logits"][slot_of[req.uid], -1].clone())
        return ok

    def _tick():
        live = [(i, r) for i, r in enumerate(engine.slots) if r is not None and r.uid in rows]
        finished = tick()
        for i, r in live:
            rows[r.uid].append(last["logits"][i, -1].clone())
        return finished

    engine._decode, engine.admit, engine.tick = _decode, _admit, _tick
    return rows, slot_of


def serial_decode(engine: ServeEngine, req: Request, slot: int) -> list[torch.Tensor]:
    """Greedy decode of one prompt alone through ``decode_step`` on the
    engine's weights: fresh caches, the prompt in ``slot`` of
    ``engine.max_batch`` (the other slots idle at length 0), so every
    operation runs at the batched run's shapes.  Returns the logits row that
    chose each generated token."""
    B = engine.max_batch
    caches = tfm.cache_init(engine.cfg, B, engine.max_len, DEVICE)
    cur = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    tok = torch.zeros(B, 1, dtype=torch.int64, device=DEVICE)
    feed, rows = [int(t) for t in req.prompt], []
    while len(rows) < req.max_new_tokens:
        for t in feed:
            tok[slot, 0] = t
            logits, caches = tfm.decode_step(engine.cfg, engine.params, caches, tok, cur)
            cur[slot] += 1
        rows.append(logits[slot, -1].clone())
        feed = [int(rows[-1].argmax())]
    return rows


def phase_lm_decode(arch, params, bits: int, n_requests: int, max_new: int) -> dict:
    full = dataclasses.replace(arch, reduced_config=arch.config)
    engine = ServeEngine(
        full, params, max_batch=8, max_len=256, quant=lm_policy(bits), device=DEVICE
    )
    reqs = lm_requests(n_requests, max_new, arch.config.vocab)
    uids = [u for u in SERIAL_UIDS if u < n_requests] if bits == 8 else []
    rows, slot_of = record_logits(engine, uids)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps = engine.decode_steps
    check(len(done) == n_requests and all(r.done for r in done), f"int{bits}: all served")
    check(all(len(r.generated) == max_new for r in done), f"int{bits}: token counts")
    vocab = arch.config.vocab
    check(all(0 <= t < vocab for r in done for t in r.generated), f"int{bits}: tokens in vocab")
    n_qdots = QDOTS_PER_LAYER * arch.config.n_layers
    check(counts["quant_matmul"] == n_qdots * steps, f"int{bits}: quant_matmul launches")
    check(counts["flash_attention"] == 0, f"int{bits}: decode launches no flash attention")
    by_uid = {r.uid: r.generated for r in done}
    if n_requests > 9:
        check(by_uid[0] == by_uid[9], "requests 0 and 9 (one prompt, two waves) differ")
    toks = sum(len(r.generated) for r in done)
    prompt_toks = sum(len(r.prompt) for r in reqs)
    first = {r.uid: r.generated[0] for r in done}
    print(
        f"lm decode int{bits}: {arch.name} full width, {n_requests} requests ({prompt_toks} "
        f"prompt tokens, prefilled token by token), {toks} generated; {steps} decode steps in "
        f"{wall:.3f} s = {1e3 * wall / steps:.3f} ms/step, {toks / wall:.1f} generated tok/s, "
        f"{(toks + prompt_toks) / wall:.1f} tok/s with prefill; req0 {by_uid[0][:6]}...; "
        f"{len(set(first.values()))} distinct first tokens over "
        f"{len({tuple(r.prompt.tolist()) for r in reqs})} distinct prompts"
    )
    if uids:
        check_against_serial(engine, reqs, by_uid, rows, slot_of)
    if bits == 8:  # where one decode step's time goes (after the counts were read)
        print(f"lm decode step split: {device_split(lambda: engine._decode(engine.last_token))}")
    return counts


def check_against_serial(engine, reqs, by_uid, rows, slot_of) -> None:
    """Each sampled request's logits and tokens, served in a batch, against a
    serial decode of its prompt alone; request 9 against request 0's serial
    decode.  Distinct prompts' rows must differ by more than the tolerance,
    so a slot mix-up or a lost cache column would fail."""
    serial = {}
    for u in rows:
        src = 0 if u == 9 else u
        if src not in serial:
            serial[src] = serial_decode(engine, reqs[src], slot_of[u])
    errs, spread = {}, {}
    for u, got_rows in rows.items():
        want_rows = serial[0 if u == 9 else u]
        check(len(got_rows) == len(want_rows) == len(by_uid[u]), f"request {u}: logits rows")
        err = 0.0
        for i, (g, w) in enumerate(zip(got_rows, want_rows)):
            scale = float(w.abs().max())
            err = max(err, float((g - w).abs().max()) / scale)
            top2 = w.topk(2).values
            if float(top2[0] - top2[1]) > 2 * SERIAL_TOL * scale:
                same = by_uid[u][i] == int(w.argmax())
                check(same, f"request {u}: token {i} differs from serial")
        errs[u] = err
        check(err <= SERIAL_TOL, f"request {u}: logits differ from a serial decode by {err:.3e}")
    first = {u: r[0] for u, r in serial.items()}
    for a, b in itertools.combinations(first, 2):
        d = float((first[a] - first[b]).abs().max()) / float(first[b].abs().max())
        spread[f"{a}-{b}"] = d
        check(d > SERIAL_TOL, f"requests {a} and {b}: distinct prompts, logits within {d:.3e}")
    print(
        f"lm decode int8 against serial decodes of requests {list(rows)} alone: max |logit| "
        f"error / max |logit| {json.dumps({u: float(f'{e:.3e}') for u, e in errs.items()})} "
        f"(limit {SERIAL_TOL}); first-token logits of distinct prompts differ by "
        f"{json.dumps({k: float(f'{d:.3e}') for k, d in spread.items()})}"
    )


# The 4096-token prefill's caches at positions [0, 256) against a 256-token
# prefill on plain ``attend``: per layer, max |difference| / the layer's max
# |value|.  Layer 0 comes before any attention, so it is bit for bit equal;
# later layers differ by bf16 rounding that compounds through the residual
# stream.  The same prefill is run again with a fault planted in the flash
# kernel's arguments; each must exceed the limit.  On an H100 the sound
# prefill reads 1.147e-2, a missing causal mask 1.753 and a 2x scale
# 2.743e-2 (the residual stream of a random model carries little of the
# attention output), so the limit sits between the sound and the 2x scale.
CACHE_TOL = 0.02
FLASH_FAULTS = {  # fault -> flash_attend's arguments with it
    "no causal mask": lambda q, kw: {**kw, "causal": False},
    "scale x2": lambda q, kw: {**kw, "scale": 2 * (kw["scale"] or q.shape[-1] ** -0.5)},
}


def cache_errs(caches, short, cfg) -> dict[str, list[float]]:
    L = cfg.n_layers
    errs = {}
    for name in ("k", "v"):
        got, want = caches["pos0"][name][:, :, :256].float(), short["pos0"][name].float()
        want_shape = (L, 1, 256, cfg.n_kv_heads, cfg.d_head)
        check(got.shape == want.shape == want_shape, f"prefill {name} cache shape")
        scale = want.abs().amax(dim=(1, 2, 3, 4))
        errs[name] = ((got - want).abs().amax(dim=(1, 2, 3, 4)) / scale).tolist()
    return errs


def phase_lm_prefill(arch, qparams) -> dict:
    prefill = arch.prefill_fn(arch.config)
    tokens = torch.from_numpy(np.random.default_rng(12).integers(0, arch.config.vocab, (1, 4096)))
    tokens = tokens.to(DEVICE)
    prefill(qparams, {"tokens": tokens[:, :8]})  # warm-up (S < 4096: no flash launch)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(qparams, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    L = arch.config.n_layers
    check(counts["flash_attention"] == L, f"prefill: {L} flash_attention launches")
    check(counts["quant_matmul"] == QDOTS_PER_LAYER * L, "prefill: 7 quant_matmul launches a layer")
    check(logits.shape == (1, 1, arch.config.vocab), "prefill logits shape")
    check(bool(torch.isfinite(logits).all()), "prefill logits finite")
    _, short = prefill(qparams, {"tokens": tokens[:, :256]})  # plain attend below 4096
    for name in ("k", "v"):
        same = torch.equal(caches["pos0"][name][0, :, :256], short["pos0"][name][0])
        check(same, f"prefill {name} cache: layer 0 not bit-identical")
    errs = cache_errs(caches, short, arch.config)
    worst = max(max(e) for e in errs.values())
    check(worst <= CACHE_TOL, f"prefill caches [0, 256) vs a 256-token prefill: {errs}")
    del caches
    planted = {}
    for fault, fkw in FLASH_FAULTS.items():
        real = attn_mod.flash_attend
        faulty = lambda q, k, v, fkw=fkw, **kw: real(q, k, v, **fkw(q, kw))
        with mock.patch.object(attn_mod, "flash_attend", faulty):
            _, bad = prefill(qparams, {"tokens": tokens})
        planted[fault] = max(max(e) for e in cache_errs(bad, short, arch.config).values())
        del bad
    per_layer = lambda e: ", ".join(f"{x:.2e}" for x in e[:: max(1, L // 6)])
    print(
        f"lm prefill: S=4096 at full width (int8) in {wall:.3f} s "
        f"({4096 / wall:.1f} tok/s); caches [0, 256) match a 256-token prefill: layer 0 "
        f"bit-identical; max err / layer max every {max(1, L // 6)} layers: "
        f"k [{per_layer(errs['k'])}], v [{per_layer(errs['v'])}]; worst {worst:.3e} (limit "
        f"{CACHE_TOL}); with a planted flash fault: "
        f"{json.dumps({f: float(f'{x:.3e}') for f, x in planted.items()})}"
    )
    for fault, reading in planted.items():
        check(reading > CACHE_TOL, f"prefill caches: planted fault {fault} passes")
    split = device_split(lambda: prefill(qparams, {"tokens": tokens}), n=2)
    print(f"lm prefill split: {split}")
    return counts


def phase_lm_card_vs_cpu(arch) -> None:
    """Full widths, 2 layers: the card (kernels) against the CPU (plain)."""
    cfg = dataclasses.replace(arch.config, n_layers=2)
    params = arch.init_params(torch.Generator().manual_seed(1), cfg)
    params_cpu = quantize_tree(params, lm_policy(8))
    params_gpu = tree_map(
        lambda _, t: t.to(DEVICE) if isinstance(t, (torch.Tensor, QTensor)) else t, params_cpu
    )
    # bf16 compute: the kernels round in other places than the plain
    # versions; hold logits to 5 % of max |logit| (tests/test_torch_lm_serve.py)
    tol = 0.05

    def agree(got, want, what):
        got, want = got.float().cpu(), want.float()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= tol * scale, f"{what}: card vs CPU max err {err} > {tol} x {scale}")
        top2 = want.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > 2 * tol * scale
        same = got.argmax(-1)[decided] == want.argmax(-1)[decided]
        check(bool(same.all()), f"{what}: greedy token differs where the margin is clear")
        return err / scale, int(decided.sum())

    tok = torch.tensor([[17], [cfg.vocab - 7]])
    cur = torch.zeros(2, dtype=torch.int32)
    caches = tfm.cache_init(cfg, 2, 8, DEVICE)
    lg, _ = tfm.decode_step(cfg, params_gpu, caches, tok.to(DEVICE), cur.to(DEVICE))
    lc, _ = tfm.decode_step(cfg, params_cpu, tfm.cache_init(cfg, 2, 8, device="cpu"), tok, cur)
    d_err, d_n = agree(lg, lc, "decode_step")
    tokens = torch.from_numpy(np.random.default_rng(13).integers(0, cfg.vocab, (1, 4096)))
    kernels.reset_launch_counts()
    pg, _ = tfm.prefill(cfg, params_gpu, tokens.to(DEVICE))
    torch.cuda.synchronize()
    check(kernels.launch_counts()["flash_attention"] == 2, "2-layer prefill launches flash twice")
    check(kernels.launch_counts()["quant_matmul"] == 2 * QDOTS_PER_LAYER, "2-layer prefill qdots")
    pc, _ = tfm.prefill(cfg, params_cpu, tokens)
    p_err, p_n = agree(pg, pc, "prefill")
    print(
        f"lm card vs CPU (full width, 2 layers, int8): decode_step max err {d_err:.3e} of max "
        f"|logit| ({d_n}/2 greedy tokens decided, equal); prefill S=4096 {p_err:.3e} "
        f"({p_n}/1 decided, equal)"
    )


# ---------------------------------------------------------------------------
# Phase 9: the Flex-plorer DSE (population sweep) at full width
# ---------------------------------------------------------------------------

DSE_T = 20
DSE_WEIGHTS = dict(c_hw=0.4, c_acc=0.4, c_perf=0.2, c_lat=0.4, c_energy=0.4, c_bw=0.2)
DSE_CKPT = ROOT / "build" / "dse_checkpoints"  # git-ignored, inside the checkout
# the sweep's CUDA kernels, as torch.profiler names them
SWEEP_KERNELS = {"spike_matmul": "spike_matmul_kernel", "lif_scan": "lif_scan_kernel"}


class PlantedKill(Exception):
    """Raised inside a search to stand for the process dying there."""


@contextlib.contextmanager
def recorded_spike_matmul(module):
    """Every ``spike_matmul`` call made through ``module`` while the block
    runs, with its operands and result (each is counted as usual)."""
    seen = []

    def recording(spk, w):
        got = spike_matmul(spk, w)
        seen.append((spk, w, got))
        return got

    with mock.patch.object(module, "spike_matmul", recording):
        yield seen


def check_recorded(seen, what: str) -> None:
    for spk, w, got in seen:
        check(torch.equal(got, spike_matmul_plain(spk, w)),
              f"{what}: spike_matmul {list(spk.shape)} x {list(w.shape)} != plain")


def front_summary(res) -> str:
    accs = [t["accuracy"] for t in res.search.trace]
    explored = res.explored_front()
    return (
        f"front {len(res.search.front)} points, explored (hw, accuracy) front {len(explored)} "
        f"points {[round(p['accuracy'], 4) for p in explored]}, accuracy span "
        f"{min(accs):.6f}..{max(accs):.6f} over {len(res.search.cache)} candidates"
    )


def dse_setup():
    """benchmarks/dse_bench.py's configuration: the 256-128-10 LIF network
    with an ATA-F hidden layer, u16, T = 20, trained on the train split of
    mnist_like(n=1536, T=20, seed=0) as dse_bench trains it (6 epochs, batch
    128, lr 2e-3; here from torch.Generator().manual_seed(0)) and searched on
    its test split; space ff_bits = rec_bits = 2..16, leak_bits = 1..8 (1800
    configurations).  The same search on the untrained (seeded random)
    weights runs first, for comparison."""
    ds = mnist_like(n=1536, T=DSE_T, seed=0)
    train, test = ds.split()
    net = NetworkConfig(
        layers=(
            LayerConfig(n_in=256, n_out=128, neuron=NeuronModel.LIF, topology=Topology.ATA_F,
                        w_bits=6, u_bits=16),
            LayerConfig(n_in=128, n_out=10, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
        ),
        n_steps=DSE_T,
        name="dse-bench-mnist-256-128-10",
    )
    bits = tuple(range(2, 17))
    space = SNNSearchSpace(ff_bits=bits, rec_bits=bits, leak_bits=tuple(range(1, 9)))
    random = init_float_params(torch.Generator().manual_seed(0), net)
    t0 = time.perf_counter()
    res = train_snn(net, train, epochs=6, batch_size=128, lr=2e-3, init_params=random)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = res.history[-1]
    print(
        f"dse: trained {net.name} on the card (6 epochs, {len(train.labels)} samples, T={DSE_T}) "
        f"in {wall:.3f} s: loss {h['loss']:.6f}, train_acc {h['train_acc']:.6f}"
    )
    print(f"dse: random weights: {front_summary(dse_search(net, random, test, space))}")
    return net, res.params, train, test, space


def dse_search(net, params, test, space, checkpoint_dir=None, refine=None):
    return explore_snn(
        net, params, test,
        search=SearchSpec(
            space=space, weights=CostWeights(**DSE_WEIGHTS), strategy="nsga2",
            config=NSGAConfig(population=64, generations=3, seed=0),
            checkpoint_dir=None if checkpoint_dir is None else str(checkpoint_dir),
        ),
        evaluate=EvalSpec(batch=max(64, len(test.labels))),
        refine=refine,
    )


def sweep_profile(net, cands, qps, test, n: int = 3, cold_tries: int = 10) -> str:
    """``n`` ``eval_int_population`` calls under torch.profiler, after one
    warm-up sweep inside the profiler's window (its schedule's warm-up step:
    the tracer is running but the sweep is not recorded): wall and device
    busy per call, and the launches of each sweep kernel as the profiler saw
    them, which must equal the wrappers' counts over the same calls.
    First, ``cold_tries`` fresh profilers, each around a single sweep with
    no warm-up (how the sweep was once profiled), are held to the wrappers'
    counts and their misses printed, unchecked."""
    sweep = lambda: eval_int_population(
        net, cands, qps, test, batch_size=len(test.labels), return_stats=True
    )
    cuda = [torch.profiler.ProfilerActivity.CUDA]

    def seen_by(prof) -> tuple[list, dict]:
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        return events, {
            name: sum(e.count for e in events if sym in e.key)
            for name, sym in SWEEP_KERNELS.items()
        }

    cold = []  # (profiler, wrappers) of each fresh profiler around one sweep
    for _ in range(cold_tries):
        before = kernels.launch_counts()
        with torch.profiler.profile(activities=cuda) as fresh:
            sweep()
            torch.cuda.synchronize()
        after = kernels.launch_counts()
        cold.append((seen_by(fresh)[1], {k: after[k] - before[k] for k in SWEEP_KERNELS}))
    missed = [c for c in cold if c[0] != c[1]]

    schedule = torch.profiler.schedule(wait=0, warmup=1, active=n, repeat=1)
    with torch.profiler.profile(activities=cuda, schedule=schedule) as prof:
        sweep()  # the warm-up step
        torch.cuda.synchronize()
        prof.step()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        for i in range(n):
            sweep()
            if i == n - 1:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / n
            prof.step()
        after = kernels.launch_counts()
    events, seen = seen_by(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6 / n
    counted = {name: after[name] - before[name] for name in SWEEP_KERNELS}
    check(seen == counted, f"the profiler's sweep launches {seen} != the wrappers' {counted}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    names = ", ".join(
        f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.3f} ms ({e.count})" for e in top
    )
    return (
        f"wall {wall:.4f} s a sweep under the profiler, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f} % busy); launches by kernel over {n} sweeps after a warm-up "
        f"sweep: profiler {json.dumps(seen)} == wrappers {json.dumps(counted)}; {len(missed)} of "
        f"{cold_tries} fresh profilers around one sweep missed launches "
        f"{[json.dumps(m[0]) for m in missed[:3]]} of {json.dumps(cold[0][1])}; top device "
        f"items per sweep (launches over {n}): {names}"
    )


def phase_dse(dse) -> dict:
    """``explore_snn`` (NSGA-II, population 64, 3 generations, c_perf and c_bw
    > 0) on the card, then: every scored candidate's sweep accuracy and
    stats against serial ``eval_int(reference)``, a repeated search, a
    search killed after generation 1 and resumed, a slice against the CPU,
    the candidate-axis ``lif_scan`` against its plain version, and the
    sweep's candidates/s at P = 64 and 512.  Returns the main path's launch
    counts."""
    net, params, _, test, space = dse
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    res = dse_search(net, params, test, space)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts["spike_matmul"] > 0 and counts["lif_scan"] > 0, "the sweep ran its kernels")
    out = res.to_json()
    cache = res.search.cache
    check(len(cache) > 64 and res.search.front, "the search scored more than one generation")
    print(
        f"dse: explore_snn nsga2 (population 64, 3 generations) over {len(cache)} candidates "
        f"of 1800 in {wall:.3f} s on the card; best {res.search.best_breakdown}; "
        f"front {len(res.search.front)} points; report {res.report()}"
    )
    print(f"dse: trained weights: {front_summary(res)}")

    # every scored candidate: the sweep against serial eval_int(reference)
    cfgs = list(cache)  # (ff_bits, rec_bits, leak_bits)
    cands = [net.replace_precisions(w_bits=a, w_rec_bits=b, leak_bits=c) for a, b, c in cfgs]
    qps = [quantize_params(c, params)[0] for c in cands]
    batch = len(test.labels)
    accs, stats = eval_int_population(net, cands, qps, test, batch_size=batch, return_stats=True)
    t0 = time.perf_counter()
    for i, (c, q) in enumerate(zip(cands, qps)):
        acc, st = eval_int(c, q, test, batch_size=batch, return_stats=True, backend="reference")
        check(acc == accs[i] == cache[cfgs[i]].accuracy, f"candidate {cfgs[i]}: sweep != serial")
        check(np.array_equal(st["input_events_per_step"], stats[i]["input_events_per_step"]),
              f"candidate {cfgs[i]}: input stats")
        for a, b in zip(st["layer_events_per_step"], stats[i]["layer_events_per_step"]):
            check(np.array_equal(a, b), f"candidate {cfgs[i]}: layer stats sweep != serial")
    serial_s = time.perf_counter() - t0
    wide = sum(1 for c in cands if c.layers[0].w_bits > 8)
    print(
        f"dse: all {len(cands)} scored candidates ({wide} with weights beyond int8) equal serial "
        f"eval_int(reference) in accuracy and float32 stats ({serial_s:.3f} s serial); "
        f"accuracies {sorted(set(np.round(accs, 6).tolist()))[:6]}..."
    )

    # the sweep's own spike_matmul launches at the search's width (its first
    # 64 candidates: layer 0 on the shared raster, layer 1 on each
    # candidate's spikes), each held bit for bit to the plain product
    with recorded_spike_matmul(backend_mod) as seen:
        eval_int_population(net, cands[:64], qps[:64], test, batch_size=batch)
    check(len(seen) == len(net.layers), "one spike_matmul launch per layer in a sweep")
    for spk, w, got in seen:
        P, (M, K), N = w.shape[0], spk.shape[-2:], w.shape[-1]
        pl = plan(M, K, N, P)
        check(torch.equal(got, spike_matmul_plain(spk, w)), f"spike_matmul {list(spk.shape)} x "
              f"{list(w.shape)} (the sweep's) != plain")
        wide = int((w.abs().amax(dim=(1, 2)) > 127).sum())
        print(
            f"kernel spike_matmul {list(spk.shape)}x{list(w.shape)} as the sweep launches it "
            f"({pl.kind}, bn {pl.bn}, grid {pl.grid[0]}x{pl.grid[1]}x{P}; {wide} candidates' "
            f"weights beyond int8): bit-identical to plain"
        )

    # repeatable; killed after generation 1 and resumed
    again = dse_search(net, params, test, space)
    check(json.dumps(again.to_json(), sort_keys=True) == json.dumps(out, sort_keys=True),
          "a second identical search differs")
    shutil.rmtree(DSE_CKPT, ignore_errors=True)
    real = explorer_mod.eval_int_population
    calls = {"n": 0}

    def dies_after_generation_1(*args, **kw):
        calls["n"] += 1  # sweep 1: the initial population, 2: generation 1
        if calls["n"] == 3:
            raise PlantedKill("killed after generation 1")
        return real(*args, **kw)

    with mock.patch.object(explorer_mod, "eval_int_population", dies_after_generation_1):
        try:
            dse_search(net, params, test, space, checkpoint_dir=DSE_CKPT)
            check(False, "the planted kill did not fire")
        except PlantedKill:
            pass
    resumed = dse_search(net, params, test, space, checkpoint_dir=DSE_CKPT)
    shutil.rmtree(DSE_CKPT, ignore_errors=True)
    check(resumed.search.front == res.search.front, "resumed front != uninterrupted front")
    check(json.dumps(resumed.to_json(), sort_keys=True) == json.dumps(out, sort_keys=True),
          "resumed search != uninterrupted search")
    print("dse: a second search gives an identical to_json(); killed after generation 1 "
          f"(sweep {calls['n']}) and resumed from its checkpoints: identical front and to_json()")

    # a slice on the card against the CPU: 4 candidates x 32 samples
    x = raster_tensor(test.spikes[:32].transpose(1, 0, 2), DEVICE)
    sl = slice(0, 4)
    stacked, b_regs, a_regs = stack_population(cands[sl], qps[sl])
    c_gpu, e_gpu = run_int_population(net, stacked, b_regs, a_regs, x, return_events=True)
    qps_cpu = [[IntLayerParams(*(t.cpu() for t in p)) for p in q] for q in qps[sl]]
    stacked, b_regs, a_regs = stack_population(cands[sl], qps_cpu)
    c_cpu, e_cpu = run_int_population(net, stacked, b_regs, a_regs, x.cpu(), return_events=True)
    check(torch.equal(c_gpu.cpu(), c_cpu) and torch.equal(e_gpu.cpu(), e_cpu), "sweep card != CPU")
    print(f"dse: 4 candidates x 32 samples: counts and emitted totals card == CPU "
          f"(emitted {int(e_cpu.sum())})")

    # candidate-axis lif_scan at the phase's shape, 64 candidates
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    stacked, b_regs, _ = stack_population(cands[:64], qps[:64])
    theta, regs = stacked[1].theta_q, b_regs[:, 1].contiguous()
    P, T, B, N = 64, DSE_T, batch, net.layers[1].n_out
    cur = torch.randint(-300, 400, (P, T, B, N), device=DEVICE, generator=gen, dtype=torch.int32)
    s1, u1 = lif_scan(cur, theta_q=theta, decay_k=regs, u_bits=16, reset_to_zero=False)
    s2, u2 = lif_scan_ref(cur, theta, regs, 16, False)
    torch.cuda.synchronize()
    check(torch.equal(s1, s2) and torch.equal(u1, u2), "candidate-axis lif_scan != plain")
    taps = max(bin(int(k) & 255).count("1") for k in regs.tolist())
    b_ms, b_by = bound(4 * (2 * P * T * B * N + P * B * N + 2 * P), P * T * B * N * (12 + 2 * taps),
                       INT32_OPS_S)
    kw = dict(theta_q=theta, decay_k=regs, u_bits=16, reset_to_zero=False)
    ms = time_ms(lambda: lif_scan(cur, **kw))
    plain_ms = time_ms(lambda: lif_scan_ref(cur, theta, regs, 16, False), reps=3, inner=2)
    print(
        f"kernel lif_scan [{P},{T},{B},{N}] int32, theta and register per candidate: "
        f"bit-identical to plain; {ms:.5f} ms, plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms "
        f"({b_by}), {share(b_ms, ms)} of the bound"
    )

    # the sweep's throughput at P = 64 and 512
    rng = np.random.default_rng(0)
    all_cfgs = list(itertools.product(space.ff_bits, space.rec_bits, space.leak_bits))
    for P in (64, 512):
        picks = [all_cfgs[i] for i in rng.choice(len(all_cfgs), P, replace=False)]
        cs = [net.replace_precisions(w_bits=a, w_rec_bits=b, leak_bits=c) for a, b, c in picks]
        qs = [quantize_params(c, params)[0] for c in cs]
        eval_int_population(net, cs, qs, test, batch_size=batch)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            eval_int_population(net, cs, qs, test, batch_size=batch, return_stats=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        best = min(times)
        print(
            f"dse sweep P={P}: {P / best:.1f} candidates/s ({best:.4f} s per sweep of "
            f"{batch} samples x T={DSE_T}, best of 3: {[round(t, 4) for t in times]})"
        )
        print(f"dse sweep P={P} split: {sweep_profile(net, cs, qs, test)}")
    print(f"dse: phase 9 took {time.perf_counter() - t_phase:.3f} s")
    return counts


def refine_step_fn(net, params, cands, x, y):
    """One candidate-axis QAT train step of ``cands`` from ``params`` on the
    batch (x, y), as ``refine_candidates`` takes it (a fresh optimizer state
    each call, so every call takes the same step)."""
    K = len(cands)
    grid = candidate_grid(cands, DEVICE)
    stacked = [torch.stack([t] * K) for p in params for t in p]
    opt = adamw(linear_warmup_cosine(5e-4, 11, 11))
    state = opt.init(stacked)
    fn = fast_sigmoid(25.0)
    return lambda: refine_step(net, opt, stacked, state, grid, x, y, fn, 1e-4)


def first_batch(ds: SpikeDataset, n: int = 128) -> tuple[SpikeDataset, torch.Tensor, torch.Tensor]:
    """The first ``n`` samples as a dataset of one batch, and as float32
    spikes [T, n, C] and labels on the card."""
    one = SpikeDataset(ds.spikes[:n], ds.labels[:n], ds.n_classes, ds.name + ":first")
    x = raster_tensor(one.spikes.transpose(1, 0, 2), DEVICE).to(torch.float32)
    return one, x, torch.from_numpy(one.labels.astype(np.int64)).to(DEVICE)


def best_wall_ms(fn, n: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return min(times)


def phase_dse_refine(dse) -> dict:
    """The search again with its QAT refine phase (``RefineSpec(top_k=4)``,
    1 epoch on the train split): each refined candidate's PTQ and refined
    accuracy against serial ``eval_int(reference)``, best >= base; then the
    candidate-axis train step at K = 4 and K = 1, its ``spike_matmul``
    launches (T x layers whatever K is, each bit-identical to plain) and
    its time.  Returns the main path's launch counts."""
    net, params, train, test, space = dse
    t0 = time.perf_counter()
    res = dse_search(net, params, test, space, refine=RefineSpec(top_k=4, train_ds=train, epochs=1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(len(res.refined) == 4, "four refined finalists")
    batch = len(test.labels)
    for r in res.refined:
        ptq = quantize_params(r.net, params)[0]
        base = eval_int(r.net, ptq, test, batch_size=batch, backend="reference")
        check(base == r.base_accuracy == res.search.cache[r.cfg].accuracy,
              f"refined {r.cfg}: base accuracy != serial eval_int of its PTQ parameters")
        refined = eval_int(r.net, r.qparams, test, batch_size=batch, backend="reference")
        check(refined == r.accuracy, f"refined {r.cfg}: accuracy != serial eval_int")
        check(r.accuracy >= r.base_accuracy, f"refined {r.cfg}: best < base")
    print(
        f"dse refine: explore_snn + RefineSpec(top_k=4, epochs=1) in {wall:.3f} s on the card; "
        "each refined finalist's base and refined accuracy == serial eval_int(reference): "
        + ", ".join(f"{r.breakdown} {r.base_accuracy:.6f} -> {r.accuracy:.6f}" for r in res.refined)
        + f"; refined front {len(res.refined_front())} points"
    )
    _, x, y = first_batch(train)
    per_step = DSE_T * len(net.layers)
    for K in (4, 1):
        step = refine_step_fn(net, params, [r.net for r in res.refined][:K], x, y)
        with recorded_spike_matmul(snn_layer_mod) as seen:
            step()
        check(len(seen) == per_step, f"refine step K={K}: {len(seen)} spike_matmul launches, "
              f"not T x layers = {per_step}")
        check_recorded(seen, f"refine step K={K}")
        shapes = sorted({f"{list(a.shape)}x{list(b.shape)}" for a, b, _ in seen})
        print(
            f"dse refine step K={K} (batch 128, T={DSE_T}): {len(seen)} spike_matmul launches "
            f"({shapes}), each bit-identical to plain; {best_wall_ms(step):.3f} ms a step"
        )
        if K == 4:
            print(f"dse refine step K=4 split: {device_split(step, n=3)}")
    return counts


# ---------------------------------------------------------------------------
# Phase 10: training at full width (examples/quickstart.py)
# ---------------------------------------------------------------------------

# The deployed accuracy must clear this floor (chance is 0.1): the port's
# CPU run of the same configuration (scripts/torch_train_cpu.py) deploys at
# 0.9903.
QS_ACC_FLOOR = 0.90
QS_EPOCHS = 8
CARD_VS_CPU_TOL = 1e-5  # tests/test_torch_cuda.py: loss relative, parameters / max |w|


def quickstart_setup():
    """examples/quickstart.py's configuration: 256-128-10 LIF, w6/u8, beta
    0.95, T = 25, on mnist_like(n=2048, T=25, seed=0) split 85/15."""
    train, test = mnist_like(n=2048, T=25, seed=0).split()
    net = NetworkConfig(
        layers=(
            LayerConfig(n_in=256, n_out=128, w_bits=6, u_bits=8, beta=0.95),
            LayerConfig(n_in=128, n_out=10, w_bits=6, u_bits=8, beta=0.95),
        ),
        n_steps=25,
        name="quickstart-mnist",
    )
    return net, train, test


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (0 for an empty tensor)."""
    if not want.numel():
        return 0.0
    return float((got.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def step_card_vs_cpu(step, params0) -> str:
    """One ``train_snn`` step (``step(params, device)``) on the card and on
    the CPU from the same parameters, held stage by stage to
    CARD_VS_CPU_TOL: the loss (relative), each gradient leaf (of its max
    |grad|, read where ``train_snn`` clips them), and the AdamW update of
    both devices from the CPU's clipped gradients (of each leaf's max |w|).

    The composed step's parameters are printed, not held to that limit:
    AdamW's first update g / (|g| + eps) turns a gradient difference dg at
    an element with |g| near eps = 1e-8 into an update difference of up to
    dg / eps, so float summation noise in such an element's gradient, far
    below the gradient limit, moves that parameter by a visible share of
    the learning rate."""
    seen = []  # (gradients, clipped gradients) of the card's step, then the CPU's
    real = opt_mod.clip_by_global_norm

    def spy(grads, max_norm, batch_dims=0):
        out = real(grads, max_norm, batch_dims)
        seen.append(([g.cpu() for g in grads], [g.cpu() for g in out[0]]))
        return out

    cpu0 = [FloatLayerParams(*(t.cpu() for t in p)) for p in params0]
    with mock.patch.object(opt_mod, "clip_by_global_norm", spy):
        card, cpu = step(params0, DEVICE), step(cpu0, "cpu")
    lc, lg = cpu.history[0]["loss"], card.history[0]["loss"]
    check(abs(lg - lc) <= CARD_VS_CPU_TOL * abs(lc), f"train step loss card {lg} vs CPU {lc}")
    (g_card, _), (g_cpu, clipped) = seen
    g_err = max(rel_err(a, b) for a, b in zip(g_card, g_cpu))
    check(g_err <= CARD_VS_CPU_TOL, f"train step gradients card vs CPU: {g_err:.3e} of max |grad|")
    # the update alone, from the same gradients on both devices (train_snn's
    # schedule for a one-step run: warm-up over that step)
    leaves = [t for p in cpu0 for t in p]
    updated = {}
    for dev in ("cpu", DEVICE):
        opt = adamw(linear_warmup_cosine(2e-3, 1, 1))
        ps = [t.to(dev) for t in leaves]
        upd, _ = opt.update([g.to(dev) for g in clipped], opt.init(ps), ps)
        updated[dev] = [p + u for p, u in zip(ps, upd)]
    u_err = max(rel_err(a, b) for a, b in zip(updated[DEVICE], updated["cpu"]))
    check(u_err <= CARD_VS_CPU_TOL, f"AdamW update card vs CPU: {u_err:.3e} of max |w|")
    worst, beyond_g = 0.0, []
    flat = lambda params: [t for p in params for t in p]
    for g, c, grad in zip(flat(card.params), flat(cpu.params), g_cpu):
        if c.numel():
            worst = max(worst, rel_err(g, c))
            beyond = (g.cpu() - c).abs() > CARD_VS_CPU_TOL * c.abs().max()
            beyond_g += grad[beyond].abs().tolist()
    return (
        f"loss {lg:.8f} vs {lc:.8f}; gradients within {g_err:.3e} of max |grad|, the AdamW "
        f"update from the same gradients within {u_err:.3e} of max |w| (limit {CARD_VS_CPU_TOL}); "
        f"the composed step's parameters within {worst:.3e} of max |w|, {len(beyond_g)} elements "
        f"beyond the limit, their |grad| {[f'{x:.2e}' for x in sorted(beyond_g)[-8:]]} (eps 1e-8)"
    )


def phase_train(qs) -> dict:
    """``train_snn`` at full width on the card (8 epochs, batch 128, lr
    2e-3), the trained net deployed through ``quantize_params`` ->
    ``eval_int`` on three backends, then a QAT epoch at w_bits = 3; after
    the counts are read: eval_qat == eval_int of the QAT deployment, a QAT
    forward's launches against plain, one train step card against CPU, and
    the train and QAT steps' time and device-busy share.  Returns the main
    path's launch counts."""
    net, train, test = qs
    t_phase = time.perf_counter()
    params0 = init_float_params(torch.Generator().manual_seed(0), net)
    t0 = time.perf_counter()
    res = train_snn(net, train, epochs=QS_EPOCHS, batch_size=128, lr=2e-3, init_params=params0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    qparams, _ = quantize_params(net, res.params)
    accs = {b: eval_int(net, qparams, test, backend=b) for b in ("reference", "fused", "event")}
    qat = PrecisionConfig(w_bits=3)
    n0 = spike_matmul.launches
    t0 = time.perf_counter()
    qres = train_snn(net, train, epochs=1, lr=5e-4, qat=qat, init_params=res.params)
    torch.cuda.synchronize()
    qat_wall = time.perf_counter() - t0
    qat_launches = spike_matmul.launches - n0
    counts = read_counts()

    steps = -(-len(train.labels) // 128)
    for h in res.history:
        print(
            f"train: epoch {h['epoch']}: loss {h['loss']:.6f}, train_acc {h['train_acc']:.6f}, "
            f"{h['seconds']:.3f} s ({1e3 * h['seconds'] / steps:.2f} ms a step)"
        )
    print(
        f"train: {net.name} (LIF 256-128-10 w6/u8, T={net.n_steps}) {QS_EPOCHS} epochs x "
        f"{steps} steps on the card in {wall:.3f} s: "
        f"{QS_EPOCHS * len(train.labels) / wall:.1f} samples/s, "
        f"{1e3 * wall / (QS_EPOCHS * steps):.2f} ms a step"
    )
    check(len(set(accs.values())) == 1, f"deployed accuracy differs across backends: {accs}")
    acc = accs["reference"]
    check(acc >= QS_ACC_FLOOR, f"deployed accuracy {acc} below the floor {QS_ACC_FLOOR}")
    print(f"train: deployed (quantize_params -> eval_int) accuracy {acc:.6f} on reference, fused "
          f"and event (floor {QS_ACC_FLOOR})")

    per_step = net.n_steps * len(net.layers)
    check(qat_launches == steps * per_step,
          f"QAT epoch: {qat_launches} spike_matmul launches, not {steps} steps x {per_step}")
    qq, _ = quantize_params(qres.qat_net, qres.params)
    acc_int, acc_qat = eval_int(qres.qat_net, qq, test), eval_qat(qres.qat_net, qres.params, test)
    check(acc_qat == acc_int, f"eval_qat {acc_qat} != eval_int of the deployment {acc_int}")
    one, x, y = first_batch(train)
    with recorded_spike_matmul(snn_layer_mod) as seen, torch.no_grad():
        run_qat(qres.qat_net, qres.params, x, fast_sigmoid(25.0))
    check(len(seen) == per_step, "a QAT forward launches spike_matmul T x layers times")
    check_recorded(seen, "QAT forward")
    print(
        f"train: QAT epoch (w_bits 3, {steps} steps) in {qat_wall:.3f} s "
        f"({1e3 * qat_wall / steps:.2f} ms a step), loss {qres.history[0]['loss']:.6f}; "
        f"{qat_launches} spike_matmul launches = {steps} steps x T x layers; eval_qat == "
        f"eval_int of the w3 deployment == {acc_int:.6f}; a QAT forward's launches "
        f"{sorted({f'{list(a.shape)}x{list(b.shape)}' for a, b, _ in seen})} bit-identical to plain"
    )

    # one train step from the same parameters on the same batch: card vs CPU
    def step(params, device, **kw):
        return train_snn(
            net, one, epochs=1, batch_size=128, init_params=params, device=device, **kw
        )

    print(f"train: one step card vs CPU: {step_card_vs_cpu(step, params0)}")
    fstep = lambda: step(params0, DEVICE)
    print(f"train step split (train_snn on one batch of 128): {device_split(fstep, n=3)}")
    qstep = lambda: step(res.params, DEVICE, lr=5e-4, qat=qat)
    print(f"QAT step split (train_snn on one batch of 128): {device_split(qstep, n=3)}")
    print(f"train: phase 10 took {time.perf_counter() - t_phase:.3f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 11: the serving front end and crash safety
# ---------------------------------------------------------------------------

FRONT_DIR = ROOT / "build" / "phase11"  # checkpoints and journals (git-ignored)
STREAM_CFG = dict(window=32, stride=16, idle_budget=None)
STREAM_STEPS, STREAM_CHUNK = 64, 16
CHUNK_UID0 = 1 << 40  # the session manager's chunk uids start here


def fresh_dir(name: str) -> Path:
    d = FRONT_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def stream_engine(net, qparams, device: str, **kw) -> SNNServeEngine:
    """The phase's engine: 64 lanes, the in-pool sparse route, 16-step ticks."""
    return SNNServeEngine(
        net, qparams, max_batch=64, backend=EventBackend(strategy="pallas"), tick_stride=16,
        device=device, **kw,
    )


def stream_groups(n_in: int) -> list[tuple[str, np.ndarray]]:
    """256 streams of 64 steps in three groups, fed one group after the
    other (a round-robin over mixed groups would make every tick int32):
    96 sparse (Bernoulli 3 %, sparse ticks), 128 dense ``mnist_like``
    (f32_exact ticks), 32 graded (values up to 3999 on 35 % of the
    channels, as in :func:`serving_traffic`: int32 ticks)."""
    rng = np.random.default_rng(11)
    sparse = (rng.random((96, STREAM_STEPS, n_in)) < 0.03).astype(np.uint8)
    dense = mnist_like(n=128, T=STREAM_STEPS, seed=12, max_rate=0.6).spikes
    on = rng.random((32, STREAM_STEPS, n_in)) < 0.35
    graded = np.where(on, rng.integers(1, 4000, on.shape), 0).astype(np.int32)
    return [("sparse", sparse), ("dense", dense), ("graded", graded)]


def prefix_oracle(net, qparams, rasters: np.ndarray, device: str) -> dict[int, np.ndarray]:
    """Serial oracle of a group's streams (``tests/test_streaming_props.py``):
    ``run_int(reference)`` of each stream's first b steps, for every stride
    boundary b, is its cumulative output count -- one batched call per b."""
    out = {0: np.zeros((len(rasters), net.n_classes), np.int64)}
    for b in range(STREAM_CFG["stride"], STREAM_STEPS + 1, STREAM_CFG["stride"]):
        x = raster_tensor(rasters[:, :b].transpose(1, 0, 2), device)
        out[b] = run_int(net, qparams, x, backend="reference").spike_counts.cpu().numpy()
    return out


def check_readouts(readouts: dict, sids: list[str], prefix: dict, what: str) -> None:
    window, stride = STREAM_CFG["window"], STREAM_CFG["stride"]
    ends = list(range(stride, STREAM_STEPS + 1, stride))
    for i, sid in enumerate(sids):
        got = readouts[sid]
        check([r[0] for r in got] == ends, f"{what}: {sid} readout ends {[r[0] for r in got]}")
        for t_end, w, counts, pred in got:
            start = max(0, t_end - window)
            want = prefix[t_end][i] - prefix[start][i]
            check(w == t_end - start and counts == want.tolist() and pred == int(np.argmax(want)),
                  f"{what}: {sid} readout at {t_end} differs from serial run_int")


def drive_streams(engine, groups, ckpt: Path | None = None):
    """Feed every group's streams chunk by chunk (round-robin within the
    group, groups one after the other), polling until each round drains;
    with ``ckpt``, evict every session of the group after each round.
    Returns the readouts by session, the wall, and the chunk latencies."""
    manager = StreamSessionManager(engine, checkpoint_dir=ckpt, config=StreamConfig(**STREAM_CFG))
    latencies = []
    t0 = time.perf_counter()
    for name, rasters in groups:
        sids = [manager.open(f"{name}{i}").sid for i in range(len(rasters))]
        for lo in range(0, STREAM_STEPS, STREAM_CHUNK):
            for sid, r in zip(sids, rasters):
                manager.feed(sid, r[lo : lo + STREAM_CHUNK])
            while not all(manager.sessions[sid].drained for sid in sids):
                latencies += [r.latency_s for r in manager.poll()]
            if ckpt is not None:
                for sid in sids:
                    manager.evict(sid)
    wall = time.perf_counter() - t0
    readouts = {
        sid: [(r.t_end, r.window, r.spike_counts.tolist(), r.prediction)
              for r in manager.drain_readouts(sid)]
        for sid in manager.sessions
    }
    return readouts, wall, latencies, manager


def phase_streams(net, qparams, front: dict, device: str = DEVICE) -> dict:
    """256 sessions of 64 steps in 16-step chunks; every readout against
    the serial oracle; all three tick modes served."""
    groups = stream_groups(net.n_in)
    engine = stream_engine(net, qparams, device)
    engine.warmup(STREAM_CHUNK, include_int32=True)
    reset_counts()
    readouts, wall, lat, manager = drive_streams(engine, groups)
    counts = read_counts()
    front["groups"], front["readouts"] = groups, readouts
    for name, rasters in groups:
        prefix = prefix_oracle(net, qparams, rasters, device)
        check_readouts(readouts, [f"{name}{i}" for i in range(len(rasters))], prefix, "stream")
    ticks = {k[5:]: v for k, v in engine.metrics.counters.items() if k.startswith("tick:")}
    for mode in ("sparse", "f32_exact", "int32"):
        check(ticks.get(mode, 0) > 0, f"streams: no {mode} tick was served")
    n_chunks = engine.metrics.counters["session_chunks"]
    n_steps = sum(len(r) for _, r in groups) * STREAM_STEPS
    check(n_chunks == n_steps // STREAM_CHUNK == len(lat), "streams: one chunk request a feed")
    p50, p99 = (1e3 * float(np.percentile(lat, q)) for q in (50, 99))
    print(
        f"streams: {len(readouts)} sessions x {STREAM_STEPS} steps, "
        f"{sum(map(len, readouts.values()))} readouts equal to serial run_int; ticks {ticks}; "
        f"{n_steps / wall:.1f} steps/s, {n_chunks / wall:.1f} chunks/s ({wall:.3f} s); "
        f"chunk p50 {p50:.3f} ms, p99 {p99:.3f} ms"
    )
    print(f"streams: {dispatch_vs_tick(engine, wall)}")
    if device == "cuda":
        dense = groups[1][1]

        def one_round():
            m = StreamSessionManager(engine, config=StreamConfig(**STREAM_CFG))
            for i, r in enumerate(dense):
                m.feed(m.open(f"r{i}").sid, r[:STREAM_CHUNK])
            m.pump()

        print(f"streams: one round of 128 dense chunks: {device_split(one_round, n=3)}")
    return counts


def phase_stream_churn(net, qparams, front: dict, device: str = DEVICE) -> dict:
    """The same streams with every session evicted to disk after each round
    (fsync + rename per evict) and restored on its next feed."""
    groups = front["groups"]
    engine = stream_engine(net, qparams, device)
    engine.warmup(STREAM_CHUNK, include_int32=True)
    ckpt = fresh_dir("churn")
    reset_counts()
    readouts, wall, _, manager = drive_streams(engine, groups, ckpt=ckpt)
    counts = read_counts()
    check(readouts == front["readouts"], "churn: readouts differ from the never-evicted run")
    c = engine.metrics.counters
    n_sessions = len(readouts)
    check(c["sessions_evicted"] == c["sessions_restored"] + n_sessions
          == n_sessions * STREAM_STEPS // STREAM_CHUNK, "churn: evictions != restores + sessions")
    n_steps = n_sessions * STREAM_STEPS
    print(
        f"churn: readouts identical to the never-evicted run; {c['sessions_evicted']} evictions, "
        f"{c['sessions_restored']} restores; {n_steps / wall:.1f} steps/s ({wall:.3f} s, "
        f"{1e3 * wall / c['sessions_evicted']:.3f} ms per evict + restore)"
    )
    return counts


def phase_journal(net, qparams, serve_results: dict, device: str = DEVICE) -> dict:
    """Phase 5's traffic again, without and with a ``Journal(fsync_every=16)``
    in turns (without, with, with, without): results equal phase 5's, and
    the journal holds a submit and a done for every request."""
    walls = {"without": [], "with": []}
    counts = {}
    for i, mode in enumerate(("without", "with", "with", "without")):
        journal = Journal(fresh_dir(f"wal{i}"), fsync_every=16) if mode == "with" else None
        engine = SNNServeEngine(net, qparams, max_batch=64, backend=EventBackend(strategy="pallas"),
                                device=device, journal=journal)
        engine.warmup(include_int32=True)
        reqs = serving_traffic(net.n_in)
        if i == 1:
            reset_counts()
        t0 = time.perf_counter()
        done = engine.run(reqs)
        walls[mode].append(time.perf_counter() - t0)
        if i == 1:
            counts = read_counts()
        check(len(done) == len(reqs), "journal: all served")
        for r in done:
            check(np.array_equal(r.spike_counts, serve_results[r.uid]),
                  f"journal: request {r.uid} differs from phase 5")
        if journal is not None:
            journal.close()
            kinds = collections.Counter(r.kind for r in read_records(journal.root))
            check(kinds == {"submit": len(reqs), "done": len(reqs)}, f"journal records {kinds}")
            check(recover(journal.root).requests == [], "journal: outstanding after a clean run")
    rate = {k: [f"{len(reqs) / w:.1f}" for w in v] for k, v in walls.items()}
    print(
        f"journal: {len(done)} requests equal to phase 5 with and without the journal; "
        f"samples/s without {rate['without']}, with {rate['with']} (fsync_every=16)"
    )
    return counts


def phase_chaos(net, qparams, device: str = DEVICE) -> dict:
    """A supervised engine with a journal and a checkpoint store serves 64
    requests and 16 streams while faults fire: a slow tick, a tick raise, a
    poisoned carry and a kill mid-service.  Every request and readout equals
    serial run_int, and the recovery counters equal what was armed."""
    root = fresh_dir("chaos")
    ckpt = root / "ckpt"
    # the tick sites count arrivals at the top of a tick (a retry arrives
    # again): round 0's tick stalls, round 1's raises once and its retry
    # serves; the carry site counts served ticks: round 2's first, whose
    # requests stay on their lanes; round 2's second tick is killed, after
    # the streams' checkpoint at step 32 and before any request completes
    inj = (
        FaultInjector()
        .arm("slow_tick", at=0, sleep_s=0.6)
        .arm("tick", at=1)
        .arm("carry", at=2)
        .arm("kill", at=4)
    )
    sup = SupervisedEngine(
        lambda: stream_engine(net, qparams, device),
        journal_dir=root / "wal",
        checkpoint_dir=ckpt,
        manager_factory=lambda eng: StreamSessionManager(
            eng, checkpoint_dir=ckpt, config=StreamConfig(**STREAM_CFG)
        ),
        faults=inj,
        slow_tick_s=0.3,
        journal_fsync_every=16,
    )
    rng = np.random.default_rng(13)
    streams = (rng.random((16, STREAM_STEPS, net.n_in)) < 0.2).astype(np.uint8)
    req_rasters = mnist_like(n=64, T=25, seed=14).spikes
    sids = [sup.manager.open(f"c{i}").sid for i in range(len(streams))]
    completed: dict[int, SNNRequest] = {}
    readouts: dict[str, dict] = {sid: {} for sid in sids}

    def drive():
        while sup.in_flight:
            for req in sup.poll():
                if req.uid < CHUNK_UID0:
                    prev = completed.setdefault(req.uid, req)
                    check(np.array_equal(prev.spike_counts, req.spike_counts),
                          f"chaos: request {req.uid} served twice, differently")
            for sid in sids:
                for r in sup.manager.drain_readouts(sid):
                    prev = readouts[sid].setdefault(r.t_end, r)
                    check(np.array_equal(prev.spike_counts, r.spike_counts),
                          f"chaos: {sid} readout at {r.t_end} re-emitted differently")

    reset_counts()
    for rnd, lo in enumerate(range(0, STREAM_STEPS, STREAM_CHUNK)):
        if rnd == 2:  # requests arrive after the streams' first checkpoint
            for uid, r in enumerate(req_rasters):
                sup.submit(SNNRequest(uid=uid, raster=r))
        for sid, r in zip(sids, streams):
            sup.manager.feed(sid, r[lo : lo + STREAM_CHUNK])
        drive()
        if rnd == 1:
            for sid in sids:
                sup.manager.evict(sid)
    counts = read_counts()
    sup.close()
    c = sup.metrics.counters
    fired = collections.Counter(site for site, _, _ in inj.fired)
    check(fired == {"slow_tick": 1, "tick": 1, "carry": 1, "kill": 1}, f"chaos: fired {fired}")
    got = {k: c[k] for k in ("tick_retries", "recoveries_warm", "recoveries_cold",
                             "quarantined_lanes", "slow_ticks")}
    armed = {"tick_retries": 1, "recoveries_warm": 0, "recoveries_cold": 1,
             "quarantined_lanes": 1, "slow_ticks": 1}
    check(got == armed, f"chaos: counters {got}, armed {armed}")
    last = sup.last_recovery
    check(last["kind"] == "cold" and last["requests_resubmitted"] > 0
          and last["sessions_reopened"] == len(sids), f"chaos: last recovery {last}")
    check(sorted(completed) == list(range(len(req_rasters))), "chaos: a request was lost")
    x = raster_tensor(req_rasters.transpose(1, 0, 2), device)
    want = run_int(net, qparams, x, backend="reference").spike_counts.cpu().numpy()
    for uid, req in completed.items():
        check(req.status == "completed" and np.array_equal(req.spike_counts, want[uid]),
              f"chaos: request {uid} differs from serial run_int")
    prefix = prefix_oracle(net, qparams, streams, device)
    check_readouts(
        {sid: [(t, r.window, r.spike_counts.tolist(), r.prediction)
               for t, r in sorted(readouts[sid].items())] for sid in sids},
        sids, prefix, "chaos",
    )
    print(
        f"chaos: {len(completed)} requests and {len(sids)} streams bit-exact through "
        f"{dict(fired)}; counters {got}; cold restart {last['duration_s']:.4f} s wall "
        f"({last['requests_resubmitted']} requests resubmitted, {last['sessions_reopened']} "
        f"sessions reopened, {last['steps_refed']} steps re-fed, "
        f"{last['records_replayed']} records replayed)"
    )
    return counts


async def http_call(port: int, method: str, path: str, body=None) -> tuple[int, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = b"" if body is None else json.dumps(body).encode()
    head = f"{method} {path} HTTP/1.1\r\nHost: smoke\r\nContent-Length: {len(payload)}\r\n\r\n"
    writer.write(head.encode() + payload)
    await writer.drain()
    data = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, rest = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


def phase_http(net, qparams, device: str = DEVICE) -> dict:
    """``SNNHttpServer`` on 127.0.0.1:0: a request through /submit and a
    stream through /session/{open,feed,close}, each against serial run_int;
    /metrics shows the stream series, /healthz answers 200."""
    rng = np.random.default_rng(15)
    raster = mnist_like(n=1, T=25, seed=16).spikes[0]
    stream = (rng.random((STREAM_STEPS, net.n_in)) < 0.2).astype(np.uint8)

    async def session():
        engine = stream_engine(net, qparams, device)
        server = AsyncSNNServer(engine)
        manager = StreamSessionManager(engine, config=StreamConfig(**STREAM_CFG))
        http = SNNHttpServer(server, streaming=AsyncStreamServer(server, manager),
                             stream_tick_s=0)
        await http.start()
        out = {}
        try:
            p = http.port
            out["submit"] = await http_call(p, "POST", "/submit",
                                            {"raster": raster.tolist(), "uid": 1})
            out["open"] = await http_call(p, "POST", "/session/open", {"sid": "h"})
            out["feed"] = [
                await http_call(p, "POST", "/session/feed",
                                {"session": "h", "chunk": stream[lo : lo + 32].tolist()})
                for lo in (0, 32)
            ]
            out["close"] = await http_call(p, "POST", "/session/close", {"session": "h"})
            out["metrics"] = await http_call(p, "GET", "/metrics")
            out["healthz"] = await http_call(p, "GET", "/healthz")
        finally:
            await http.stop()
        return out

    reset_counts()
    out = asyncio.run(session())
    counts = read_counts()
    for key in ("submit", "open", "close", "metrics", "healthz"):
        check(out[key][0] == 200, f"http: {key} answered {out[key][0]}")
    check(all(status == 200 for status, _ in out["feed"]), "http: a feed failed")
    x = raster_tensor(raster[:, None, :], device)
    want = run_int(net, qparams, x, backend="reference").spike_counts[0].cpu().numpy()
    check(json.loads(out["submit"][1])["spike_counts"] == want.tolist(),
          "http: /submit differs from serial run_int")
    got = [r for _, body in out["feed"] for r in json.loads(body)["readouts"]]
    prefix = prefix_oracle(net, qparams, stream[None], device)
    check_readouts({"h": [(r["t_end"], r["window"], r["spike_counts"], r["prediction"])
                          for r in got]}, ["h"], prefix, "http")
    check(json.loads(out["close"][1])["t_total"] == STREAM_STEPS, "http: close summary")
    series = {}
    for line in out["metrics"][1].decode().splitlines():
        if line.startswith("neura_stream_"):
            name, value = line.rsplit(" ", 1)
            series[name] = float(value)
    for event in ("sessions_opened", "sessions_closed", "session_chunks", "session_readouts"):
        check(series.get(f'neura_stream_events_total{{event="{event}"}}', 0) > 0,
              f"http: /metrics shows no {event}")
    check(json.loads(out["healthz"][1])["status"] == "ok", "http: /healthz status")
    nonzero = sum(v > 0 for v in series.values())
    print(
        f"http: /submit and 4 readouts over /session/* equal to serial run_int; /metrics "
        f"{nonzero} of {len(series)} neura_stream_* series nonzero; /healthz 200"
    )
    return counts


def phase_launcher(device: str = DEVICE) -> dict:
    """``repro_torch.launch.serve_snn.main`` in replay mode and in
    ``--streaming 16`` mode, on the card; each must return normally."""
    runs = [
        ["--requests", "64", "--max-batch", "64", "--T", "25",
         "--journal", str(fresh_dir("launcher-wal"))],
        ["--streaming", "16", "--stream-steps", "64", "--stream-chunk", "16",
         "--stream-window", "32", "--stream-stride", "16", "--stream-idle", "2",
         "--stream-ckpt", str(fresh_dir("launcher-ckpt")), "--max-batch", "64", "--no-journal"],
    ]
    reset_counts()
    outs = []
    for argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_snn.main([*argv, "--device", device])
        outs.append(buf.getvalue())
    counts = read_counts()
    check("served 64 requests" in outs[0], "launcher: replay report")
    check("streamed 16 sessions x 64 steps" in outs[1], "launcher: streaming report")
    for out in outs:
        for line in out.splitlines():
            if "throughput" in line or line.startswith(("served", "streamed", "  churn")):
                print(f"launcher: {line.strip()}")
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
    t_start = time.perf_counter()
    # the certified f32 lowering and the LM's f32 logits head need full f32
    torch.backends.cuda.matmul.allow_tf32 = False
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

    arch = get_arch(LM_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = [
        check_spike_matmul(gen, [p.w_ff for p in qparams]),
        check_lif_scan(gen),
        check_sparse_accum(gen, qparams[0].w_ff),
        check_quant_matmul(gen, arch.config.n_layers),
        check_flash_attention(gen, arch.config.n_layers),
    ]
    for r in rows:
        how = "bit-identical to" if r["max_abs_err"] == 0 else "within the bf16 tolerance of"
        print(
            f"kernel {r['name']} {r['shape']}: {how} plain (max_abs_err "
            f"{r['max_abs_err']}); {r['ms']:.5f} ms, plain {r['plain_ms']:.5f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
        )

    t0 = time.perf_counter()
    lm_params = arch.init_params(torch.Generator(device=DEVICE).manual_seed(0))
    lm_int8 = quantize_tree(lm_params, lm_policy(8))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(lm_params))
    print(
        f"lm model: {arch.name} at full width ({arch.config.n_layers} layers, d_model "
        f"{arch.config.d_model}, vocab {arch.config.vocab}), {n_params} f32 parameters from "
        f"torch.Generator('cuda').manual_seed(0), int8 block weights; "
        f"{time.perf_counter() - t0:.2f} s"
    )

    launches = dict.fromkeys(build.KERNELS, 0)
    serve_results: dict = {}
    for name, phase in [
        ("run_int", lambda: phase_run_int(net, qparams, qparams_cpu)),
        ("eval_int", lambda: phase_eval_int(net, qparams)),
        ("serve", lambda: phase_serve(net, qparams, serve_results)),
        ("lm_decode_int8", lambda: phase_lm_decode(arch, lm_params, 8, 16, 16)),
        ("lm_decode_int4", lambda: phase_lm_decode(arch, lm_params, 4, 4, 8)),
        ("lm_prefill", lambda: phase_lm_prefill(arch, lm_int8)),
    ]:
        # each phase reads the counts right after driving the main path,
        # before its own checks launch anything
        reset_counts()
        with launch_sizes() as tally:
            counts = phase()
        print(f"launches[{name}]: {counts}")
        if tally:
            by_shape = {f"{k}{list(v)}": n for (k, v), n in sorted(tally.items())}
            print(f"launches by size[{name}] (the launches counted above): {json.dumps(by_shape)}")
        for k, v in counts.items():
            launches[k] += v
    del lm_params, lm_int8
    torch.cuda.empty_cache()
    phase_lm_card_vs_cpu(arch)

    t0 = time.perf_counter()
    dse = dse_setup()
    qs = quickstart_setup()
    for name, phase in [
        ("dse", lambda: phase_dse(dse)),
        ("dse_refine", lambda: phase_dse_refine(dse)),
        ("train", lambda: phase_train(qs)),
    ]:
        reset_counts()
        with launch_sizes() as tally:
            counts = phase()
        print(f"launches[{name}]: {counts}")
        by_shape = {f"{k}{list(v)}": n for (k, v), n in sorted(tally.items())}
        print(f"launches by size[{name}] (the launches counted above): {json.dumps(by_shape)}")
        for k, v in counts.items():
            launches[k] += v
    print(f"phases 9-10 took {time.perf_counter() - t0:.3f} s; the script so far "
          f"{time.perf_counter() - t_start:.3f} s")

    t0 = time.perf_counter()
    front: dict = {}
    for name, phase in [
        ("streams", lambda: phase_streams(net, qparams, front)),
        ("stream_churn", lambda: phase_stream_churn(net, qparams, front)),
        ("journal", lambda: phase_journal(net, qparams, serve_results)),
        ("chaos", lambda: phase_chaos(net, qparams)),
        ("http", lambda: phase_http(net, qparams)),
        ("launcher", lambda: phase_launcher()),
    ]:
        reset_counts()
        with launch_sizes() as tally:
            counts = phase()
        print(f"launches[{name}]: {counts}")
        by_shape = {f"{k}{list(v)}": n for (k, v), n in sorted(tally.items())}
        print(f"launches by size[{name}] (the launches counted above): {json.dumps(by_shape)}")
        if name == "streams":
            for k in ("spike_matmul", "sparse_accum"):
                check(counts[k] > 0, f"phase 11: {k} was not launched by the streams")
        for k, v in counts.items():
            launches[k] += v
    print(f"phase 11 took {time.perf_counter() - t0:.3f} s; the script so far "
          f"{time.perf_counter() - t_start:.3f} s")
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
