#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result as one JSON line.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Set-up (process start, inputs and weights from the seed, the program's
set-up, its kernels built or loaded, one warm-up call) is ``setup_s``; then
the cell's calls run for ``--seconds``.  With ``--trace 0`` the line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
under ``torch.profiler``.  After the window the program's output is held to
the plain reference (``reference.py``): each compared number and its limit go
to standard error as its last lines and under ``checks``, last in the line.
Exits non-zero with no result line where there is no card, where the program
cannot be imported, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_TOP = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# every build and kernel cache inside the checkout, at a fixed path
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import trace  # noqa: E402


def process_age() -> float:
    """Seconds since this process started (the kernel's start time, to its
    clock tick), or since this module was first read where that is unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_TOP


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: dict, trace_on: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace_on`` its per-layer ones."""
    group = bench["per_layer" if trace_on else "end_to_end"]
    return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names (compared whole) of JAX or the JAX package among
    ``modules`` (the names in ``sys.modules`` by default)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(bench, cell, seed, seconds, trace_on, device, config=None, traffic=None):
    """One run of ``cell``: the result line (a dict) and the seconds of its
    stages.  ``config`` / ``traffic`` replace the cell's files (the tests'
    small sizes)."""
    config = config or load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = traffic or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    driver_mod = importlib.import_module(f"perfbench.drivers.{traffic['kind']}")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        # the event path's f32 lowering is exact only at full float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        from repro_torch.kernels import build

        build.load_all()
    driver = driver_mod.Driver(config, traffic, seed, device)
    driver.warmup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age()
    breakdown = None
    if trace_on:
        t_trace = time.perf_counter()
        tr = trace.traced_window(driver, seconds, device)
        window = tr.window
        breakdown = {
            "device_ops": [[k, s] for k, (s, _) in sorted(tr.kernels.items(), key=lambda kv: -kv[1][0])[:10]],
        }
    else:
        tr = None
        window = trace.timed_window(driver, seconds, device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if trace_on:
        breakdown["idle_gaps"] = trace.idle_gaps(driver, device)
        t_trace = time.perf_counter() - t_trace - window.wall_s
    driver.free()
    t_check = time.perf_counter()
    checks, failed = driver.check()
    stages = {"setup_s": setup_s, "window_s": window.wall_s, "check_s": time.perf_counter() - t_check}
    stages["call_s"] = window.call_s
    if trace_on:
        stages["trace_s"] = t_trace
    ctx = SimpleNamespace(driver=driver, window=window, trace=tr, setup_s=setup_s)
    metrics = {}
    for m in metrics_of(bench, cell, trace_on):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = traffic["limits"]
    result = {
        "correct": all(checks[k] <= limits[k] for k in limits),
        "attempted": window.units,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
            "power_limit_w": power_limit_w() if on_card else None,
        },
    }
    if trace_on:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = window.wall_s
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    return result, stages


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec()
    cell = cell_of(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    result, stages = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda")
    leaked = forbidden_modules()
    if leaked:
        print(f"JAX or the JAX package was loaded: {leaked}", file=sys.stderr)
        return 3
    q = np.percentile(stages.pop("call_s"), [0, 10, 50, 90, 100])
    print(" ".join(f"{k} {v:.3f}" for k, v in stages.items()), file=sys.stderr)
    print("call seconds min p10 p50 p90 max " + " ".join(f"{v:.4f}" for v in q), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
