#!/usr/bin/env python3
"""How often torch.profiler misses a launch in chip_smoke.py phase 9's
profiled window, and which one.

    python3 scripts/profiler_window_check.py [WINDOWS [SETTLE_MS ...]]   # one card

Phase 9 profiles the P = 64 population sweep in a window of one warm-up
sweep and three recorded ones, and holds the profiler's launches of
``spike_matmul`` and ``lif_scan`` to the wrappers' counts.  This repeats
that window WINDOWS times (default 200) on the same search set-up, once for
each SETTLE_MS (default 0: the host waits that long after the profiler
starts recording, before the first recorded sweep), and prints, as JSON: the windows in which a kernel record was missing, the
device-event count of a complete window, whether every sweep's accuracies
equal an unprofiled sweep's (so a missing record is the profiler's, not a
launch that did not run), and, for each incomplete window, which sweep
lacks its layer-0 ``spike_matmul`` and the kernels' start times.
"""

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def run(windows: int, settle_ms: float, sweep, want) -> None:
    cuda = [torch.profiler.ProfilerActivity.CUDA]
    complete, incomplete, wrong = set(), [], 0
    for w in range(windows):
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=3, repeat=1)
        outs = []
        with torch.profiler.profile(activities=cuda, schedule=schedule) as prof:
            sweep()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(settle_ms / 1e3)
            for i in range(3):
                outs.append(sweep()[0])
                if i == 2:
                    torch.cuda.synchronize()
                prof.step()
        wrong += sum(not np.array_equal(o, want) for o in outs)
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        layer0 = sorted(e.time_range.start for e in ev if "spike_matmul_kernel<16" in e.name)
        lif = sorted(e.time_range.start for e in ev if "lif_scan_kernel" in e.name)
        if len(layer0) == 3 and len(lif) == 3:
            complete.add(len(ev))
            continue
        # sweep i's layer-0 product starts after sweep i-1's lif_scan and before sweep i's
        lacking = [
            i for i in range(len(lif))
            if not any((lif[i - 1] if i else -1.0) < t < lif[i] for t in layer0)
        ]
        first = min(e.time_range.start for e in ev)
        incomplete.append({
            "window": w, "device_events": len(ev), "sweep_lacking_layer0": lacking,
            "layer0_starts_us": [round(t - first, 1) for t in layer0],
            "lif_scan_starts_us": [round(t - first, 1) for t in lif],
        })
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "device": smi, "windows": windows, "settle_ms": settle_ms,
        "incomplete": len(incomplete), "complete_window_events": sorted(complete),
        "sweeps_with_other_accuracies": wrong,
    }))
    for rec in incomplete:
        print(json.dumps(rec))


def main(windows: int, settles: list[float]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiler_window_check: needs an NVIDIA card")
    torch.set_float32_matmul_precision("highest")
    cs.build.load_all()
    net, params, _, test, space = cs.dse_setup()
    rng = np.random.default_rng(1)
    all_cfgs = list(itertools.product(space.ff_bits, space.rec_bits, space.leak_bits))
    picks = [all_cfgs[i] for i in rng.choice(len(all_cfgs), 64, replace=False)]
    cands = [net.replace_precisions(w_bits=a, w_rec_bits=b, leak_bits=c) for a, b, c in picks]
    qs = [cs.quantize_params(c, params)[0] for c in cands]
    batch = len(test.labels)
    sweep = lambda: cs.eval_int_population(net, cands, qs, test, batch_size=batch, return_stats=True)
    want = sweep()[0]
    for settle_ms in settles:
        run(windows, settle_ms, sweep, want)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 200, [float(x) for x in sys.argv[2:]] or [0.0])
