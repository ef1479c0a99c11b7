"""BENCHMARK.json against the rules of its format and its own files.

Every cell resolves to its configuration, traffic, driver and metric readers;
names, units and texts keep to the format's characters and lengths; every
per-layer metric moves an end-to-end metric that its cells report; nothing of
the harness imports JAX, the JAX package or the JAX benchmarks, and the
reference imports nothing of the port.
"""

from __future__ import annotations

import ast
import importlib
import json
import re

import pytest
from _perfbench_tiny import ROOT, run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HARNESS = sorted((ROOT / "perfbench").rglob("*.py"))


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {
        "command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"
    }
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_resolves_to_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    config = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert (ROOT / config["file"]).is_file()
    assert config["file"] == f"perfbench/configs/{cell['config']}.json"
    traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = importlib.import_module(f"perfbench.drivers.{traffic['kind']}")
    assert hasattr(driver, "Driver")
    for m in run.metrics_of(BENCH, cell, False) + run.metrics_of(BENCH, cell, True):
        assert callable(run.reader(m["name"]))


def test_names_units_and_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for name in names + [c["traffic"] for c in BENCH["workloads"]]:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [e["why"] for e in BENCH["configs"] + BENCH["workloads"]] + [
        m["layer"] for m in BENCH["per_layer"]
    ]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_configs_cut_nothing_and_are_used():
    used = {c["config"] for c in BENCH["workloads"]}
    for config in BENCH["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert config["reduced"] == [] and config["name"] in used
        assert config["source"].startswith("https://")


def test_end_to_end_metrics_and_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in BENCH["workloads"]:
        reported = {m["name"] for m in run.metrics_of(BENCH, cell, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert run.metrics_of(BENCH, cell, True)


def test_each_per_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell_name in m["workloads"]:
            cell = run.cell_of(BENCH, cell_name)
            assert m["moves"] in {e["name"] for e in run.metrics_of(BENCH, cell, False)}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"device", "kernels", "population sweep", "backend"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(ROOT)))
def test_harness_imports_neither_jax_nor_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "work.py", "data.py", "trace.py"):
        tops = {n.split(".")[0] for n in _imports(ROOT / "perfbench" / name)}
        assert "repro_torch" not in tops, name


def test_the_import_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core.backend", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.core.network", "repro_torch"]) == ["repro"]
    assert run.forbidden_modules(["jax._src.core", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"
    ]
