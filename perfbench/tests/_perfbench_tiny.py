"""Small sizes of the benchmark's cells for the CPU tests (not collected)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench import run  # noqa: E402

CELLS = [c["name"] for c in run.spec()["workloads"]]
# (config, traffic) of every traffic kind, those of no cell yet included
PAIRS = [(c["config"], c["traffic"]) for c in run.spec()["workloads"]] + [
    ("snn-mnist-lif-ff", "infer_10k")
]


def tiny(pair, T: int = 4, samples: int = 16):
    """(bench, cell, config, traffic) of a (config, traffic) pair cut to ``T``
    steps, ``samples`` samples, 8 candidates a sweep (a sweep of a whole space
    keeps it whole), batches of 6 and 2 sets for inference, 2 sweeps checked;
    the cell is the benchmark's where it has one, else one made for the pair."""
    bench = run.spec()
    cell = next(
        (c for c in bench["workloads"] if (c["config"], c["traffic"]) == tuple(pair)),
        {"name": f"{pair[0]}.{pair[1]}", "config": pair[0], "traffic": pair[1], "chips": 1},
    )
    config = run.load_json(run.HERE / "configs" / f"{pair[0]}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{pair[1]}.json")
    config["network"]["n_steps"] = T
    traffic["samples"] = samples
    if traffic["kind"] == "sweep":
        traffic["population"] = traffic["population"] and 8
        traffic["check_sweeps"] = 2
    else:
        traffic["batch"] = 6
        traffic["datasets"] = 2
    return bench, cell, config, traffic


def run_tiny(pair, seed: int = 2**31 + 7, seconds: float = 0.2, **kw):
    bench, cell, config, traffic = tiny(pair, **kw)
    return run.run_cell(bench, cell, seed, seconds, False, "cpu", config, traffic)
