"""Whole runs of the cells at small sizes on the CPU: the result line has the
keys a result line must have, a run without a card refuses, and a run whose timed path is
broken underneath comes out not correct."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest
import torch
from _perfbench_tiny import CELLS, PAIRS, run, run_tiny

from repro_torch.core import backend
from perfbench.drivers import infer as infer_driver
from perfbench.drivers import sweep as sweep_driver
from repro_torch.data.snn_datasets import SpikeDataset

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("pair", PAIRS, ids="/".join)
def test_result_line_has_the_required_keys(pair):
    result, stages = run_tiny(pair)
    assert list(result) == KEYS  # "checks" comes last
    json.dumps(result)
    if pair[1] != "infer_10k":  # a traffic of no cell reports no metric yet
        cell = next(c for c in run.spec()["workloads"] if (c["config"], c["traffic"]) == pair)
        want = {m["name"]: m["unit"] for m in run.metrics_of(run.spec(), cell, False)}
        assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"acc_gap", "event_gap"}
    assert stages["window_s"] >= 0.2


def test_a_run_without_a_card_refuses_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "mnist-ataf.sweep", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""


def _half_batch(fn):
    """The evaluation over the first half of the samples only."""

    def wrapped(*args, **kw):
        args = list(args)
        i = next(i for i, a in enumerate(args) if isinstance(a, SpikeDataset))
        ds = args[i]
        n = len(ds.labels) // 2
        args[i] = SpikeDataset(ds.spikes[:n], ds.labels[:n], ds.n_classes, ds.name)
        return fn(*args, **kw)

    return wrapped


def _flip_one(fn):
    """One spike of a layer's output raster flipped where it is produced."""

    def wrapped(*args, **kw):
        spikes = fn(*args, **kw).clone()
        idx = (0,) * spikes.dim()
        spikes[idx] = 1 - spikes[idx]
        return spikes

    return wrapped


def _unchanged(fn):
    """Every step returns the layer's state unchanged: no neuron ever spikes."""

    def wrapped(*args, **kw):
        return torch.zeros_like(fn(*args, **kw))

    return wrapped


FAULTS = {
    "half_batch": {
        "sweep": (sweep_driver, "eval_int_population", _half_batch),
        "infer": (infer_driver, "eval_int", _half_batch),
    },
    "answer_altered": {
        "sweep": (backend, "_population_window", _flip_one),
        "infer": (backend, "int_layer_window_from_currents", _flip_one),
    },
    "state_unchanged": {
        "sweep": (backend, "_population_window", _unchanged),
        "infer": (backend, "int_layer_window_from_currents", _unchanged),
    },
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("pair", PAIRS, ids="/".join)
def test_a_broken_timed_path_is_not_correct(monkeypatch, pair, fault):
    kind = "infer" if pair[1].startswith("infer") else "sweep"
    module, name, breaker = FAULTS[fault][kind]
    monkeypatch.setattr(module, name, breaker(getattr(module, name)))
    result, _ = run_tiny(pair)
    assert result["correct"] is False and result["failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_cells_run_on_the_card(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench = run.spec()
    result, _ = run.run_cell(bench, run.cell_of(bench, cell_name), 2**31 + 5, 1.0, False, "cuda")
    assert result["correct"] and result["device"]["platform"] == "gpu"
