#!/usr/bin/env python3
"""``spike_matmul`` alone at the population sweep's layer-0 shape, and what
ptxas reports for each instantiation of its kernel.

    python3 scripts/spike_matmul_timing.py [--reps 40] [--ptxas] [--shapes layer0 ...]   # one card

Times one launch at each of the population sweep's shapes at P = 512
(``mnist-ataf.sweep``'s layer 0, [4620, 256] binary spikes shared by every
candidate times [512, 256, 128] weights; its layer 1; one step of
``mnist-atat.sweep``'s recurrence) and at the fused backend's single
[25600, 256] x [256, 128] and [25600, 128] x [128, 10] products, each twice: with 16-bit weights, which
take the two weight byte planes, and with 8-bit ones, which take the one
int8 pass.  Each is device ms a launch (the profiler's kernel time over
``--reps`` launches after a warm-up), beside its bound (the larger of its
bytes at 3.35 TB/s and its operations at the int8 tensor cores' 1,979
TOP/s).  Every timed product is first held to the int64 product wrapped to
int32 for its first and last candidate.  With ``--ptxas`` the
kernel source is compiled once more with ``-Xptxas -v`` and each
``spike_matmul_kernel<kTiles, kBatched>``'s registers, stack and spill bytes
are printed (and those of the item loop it calls apart, where there is one).  Prints one JSON line naming the card and its power limit.  Run
from the root of a checkout: it imports that checkout's ``src``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path.cwd()
sys.path[:0] = [str(ROOT / "src")]

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.quant_matmul.spike_matmul import spike_matmul  # noqa: E402

# name: (P, M, K, N, shared spikes); P None is a single product
SHAPES = {
    "layer0": (512, 20 * 231, 256, 128, True),  # mnist-ataf.sweep's layer 0, P = 512
    "layer1": (512, 20 * 231, 128, 10, False),  # its layer 1
    "recurrence": (512, 231, 128, 128, False),  # one step of mnist-atat.sweep's recurrence
    "single": (None, 25600, 256, 128, False),  # the fused backend's window, T = 25 x B = 1024
    "single_n10": (None, 25600, 128, 10, False),  # its output layer
}
HBM_BYTES_S, INT8_OPS_S = 3.35e12, 1979e12


def ptxas_report() -> dict:
    """{"spike_matmul_kernel<kTiles, kBatched>" (and the item loop it calls,
    ``weight_plane_items<kTiles>``, where the source has one): {registers,
    stack, spill_stores, spill_loads}}, as far as ptxas reports each."""
    src = build.CSRC / "spike_matmul.cu"
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/k.so", str(src)]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    report, name = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"(spike_matmul_kernel|weight_plane_items)ILi(\d+)E(?:Lb([01])E)?", line)
        if m and ("Compiling entry function" in line or "Function properties" in line):
            flag = {None: "", "0": ", false", "1": ", true"}[m.group(3)]
            name = f"{m.group(1)}<{m.group(2)}{flag}>"
            report.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[name].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m[1])
            name = None
    return report


def timed(s: torch.Tensor, w: torch.Tensor, reps: int) -> float:
    """Device ms a launch: the profiler's ``spike_matmul_kernel`` time over
    ``reps`` launches (host time between launches left out: at the single
    product the kernel runs for less time than its wrapper takes to launch
    it), or CUDA events around them where the profiler sees no device time."""
    for _ in range(3):
        spike_matmul(s, w)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            spike_matmul(s, w)
        end.record()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if "spike_matmul_kernel" in e.key]
    us, n = sum(e.self_device_time_total for e in hits), sum(e.count for e in hits)
    return us / 1e3 / n if us > 0 else start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    build.build_all(("spike_matmul",))  # this kernel alone: load it before entry() builds all
    build._LIBS["spike_matmul"] = ctypes.CDLL(str(build._library_path("spike_matmul")))
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": smi}
    for name in args.shapes:
        P, M, K, N, shared = SHAPES[name]
        batch = P or 1
        s = (torch.rand(*(() if shared or P is None else (P,)), M, K, device="cuda", generator=gen)
             < 0.15).to(torch.int32)
        s_bytes = s.numel() * 4
        bound_ms = 1e3 * max((s_bytes + 4 * batch * (K * N + M * N)) / HBM_BYTES_S,
                             2 * batch * M * K * N / INT8_OPS_S)
        row = result[name] = {"shape": f"{list(s.shape)} x {[P, K, N] if P else [K, N]}",
                              "bound_ms": bound_ms}
        for bits in (16, 8):
            lim = 2 ** (bits - 1)
            w = torch.randint(-lim, lim, (*((P,) if P else ()), K, N), device="cuda",
                              generator=gen, dtype=torch.int32)
            got = spike_matmul(s, w)
            for c in ((0, batch - 1) if P else (None,)):
                s_c = (s if s.dim() == 2 else s[c]).cpu().numpy().astype(np.int64)
                w_c = (w if c is None else w[c]).cpu().numpy().astype(np.int64)
                want = (s_c @ w_c).astype(np.uint32).view(np.int32)
                if not np.array_equal((got if c is None else got[c]).cpu().numpy(), want):
                    raise SystemExit(f"{name} w{bits}: candidate {c} differs from the int64 product")
            ms = timed(s, w, args.reps)
            row[f"w{bits}"] = {"ms": ms, "roofline_pct": 100 * bound_ms / ms}
    if args.ptxas:
        result["ptxas"] = ptxas_report()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
