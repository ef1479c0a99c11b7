#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, at a cell's own size.

    python perfbench/control.py --workload <cell> --seeds <n> [<n> ...] [--out FILE]

For each seed, in one process: the program's calls, as many as a run
compares, held to the reference (the lower readings), then the control (the
reference one bit coarser, ``reference.precision_drop=1``) in the program's
place, held to the same reference (the upper readings).  Prints one JSON line a
seed, with the hidden layer's events per sample beside them.  Not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402
import torch  # noqa: E402


def readings(cell_name: str, seed: int, device: str = "cuda", config=None, traffic=None) -> dict:
    bench = run.spec()
    cell = run.cell_of(bench, cell_name)
    config = config or run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    traffic = traffic or run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    mod = __import__(f"perfbench.drivers.{traffic['kind']}", fromlist=["Driver"])
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    driver = mod.Driver(config, traffic, seed, device)
    n_calls = traffic.get("check_sweeps", traffic.get("datasets"))
    for _ in range(n_calls):
        driver.call()
    program, failed = driver.check()
    first = driver.done[0]
    truth = driver.truth(first[0])
    hidden = truth.emitted[:, :, 0].sum(axis=1) / truth.n
    driver.done = []
    driver.evaluate = driver.control
    for _ in range(n_calls):
        driver.call()
    control, control_failed = driver.check()
    return {
        "workload": cell_name,
        "seed": seed,
        "program": program,
        "program_failed": failed,
        "control": control,
        "control_failed": control_failed,
        "hidden_events_per_sample": [float(hidden.min()), float(hidden.mean()), float(hidden.max())],
        "input_events_per_sample": float(truth.input_events.sum() / truth.n),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control readings are taken on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        line = json.dumps(readings(args.workload, seed))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
