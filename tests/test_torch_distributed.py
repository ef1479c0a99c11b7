"""The port's multi-process plumbing: ``distributed/compat.py`` and the
fleet fan-out of ``core/shard.py`` and ``explore_snn``.

The runtime queries without a process group, ``host_bounds``' refusals,
``allgather_hosts`` at one process and with an injected gather (as
``tests/test_distribution.py`` injects JAX's), and one real 2-process gloo
run: ``explore_snn`` (population anneal, perf terms on, so the scores *and*
the event statistics are all-gathered) gives rank 0 the same ``to_json()``
as one process.  The two processes meet through a ``file://`` rendezvous
under ``tmp_path`` and run under a wall limit of their own.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import network as tnet
from repro_torch.core import shard
from repro_torch.core import snn_layer as tsl
from repro_torch.core.flexplorer import explorer as texp
from repro_torch.core.flexplorer import strategies as TS
from repro_torch.core.flexplorer.cost import CostWeights
from repro_torch.data import snn_datasets as tds
from repro_torch.distributed import compat

ROOT = Path(__file__).resolve().parents[1]
WALL_S = 120  # the 2-process test's own limit


@pytest.fixture
def no_coordinator(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)


def test_compat_without_a_coordinator(no_coordinator):
    assert compat.process_count() == 1 and compat.process_index() == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert compat.maybe_init_distributed() is False
    assert compat.process_count() == 1
    assert compat.enable_compilation_cache("/nonexistent") is False  # nothing to cache


def test_compat_failed_init_warns_and_stays_single_process(no_coordinator, tmp_path):
    """A rank outside the world size fails at once: a warning, False, and
    the run carries on in one process (JAX's degradation)."""
    with pytest.warns(RuntimeWarning, match="continuing in one process"):
        ok = compat.maybe_init_distributed(f"file://{tmp_path / 'rdv'}", 2, 5)
    assert ok is False and compat.process_count() == 1


def test_compat_reads_torchrun_environment(monkeypatch):
    """No explicit arguments: torchrun's MASTER_ADDR / MASTER_PORT,
    WORLD_SIZE and RANK; explicit arguments win over them."""
    seen = []
    monkeypatch.setattr(compat.dist, "init_process_group", lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert compat.maybe_init_distributed() is True
    assert compat.maybe_init_distributed("file:///x/rdv", 2, 1) is True
    (b0, k0), (b1, k1) = seen
    assert b0 == b1 == "gloo"
    assert (k0["init_method"], k0["world_size"], k0["rank"]) == ("tcp://10.0.0.7:29511", 4, 3)
    assert (k1["init_method"], k1["world_size"], k1["rank"]) == ("file:///x/rdv", 2, 1)
    assert k0["timeout"] == compat.INIT_TIMEOUT


@pytest.mark.parametrize(
    "n,index,count,match",
    [(8, 2, 2, "outside"), (8, -1, 2, "outside"), (7, 0, 2, "does not divide")],
)
def test_host_bounds_refusals(n, index, count, match):
    with pytest.raises(ValueError, match=match):
        shard.host_bounds(n, index=index, count=count)


def test_host_bounds_partition():
    assert shard.host_bounds(8, index=0, count=1) == (0, 8)
    assert [shard.host_bounds(12, index=i, count=3) for i in range(3)] == [(0, 4), (4, 8), (8, 12)]
    assert shard.host_bounds(8) == (0, 8)  # no process group: this process owns it all


def test_allgather_hosts_identity_and_injected_gather():
    local = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(shard.allgather_hosts(local), local)
    np.testing.assert_array_equal(shard.allgather_hosts(local, count=1), local)
    seen = []

    def gather(x):
        seen.append(x.shape)
        return np.concatenate([x, x + 100])

    got = shard.allgather_hosts(local, count=2, gather=gather)
    assert seen == [(3, 2)]
    np.testing.assert_array_equal(got, np.concatenate([local, local + 100]))


# ---------------------------------------------------------------------------
# Two processes over gloo
# ---------------------------------------------------------------------------


def search() -> dict:
    """A seeded population-anneal DSE on a tiny net (numpy weights and
    data): its ``to_json()``.  Population 4 is a multiple of 2 processes,
    so the sweep widths are the single process's."""
    net = tnet.NetworkConfig(
        layers=(
            tsl.LayerConfig(n_in=32, n_out=16, neuron=tsl.NeuronModel.LIF, beta=0.9),
            tsl.LayerConfig(n_in=16, n_out=4, neuron=tsl.NeuronModel.LIF, beta=0.77),
        ),
        n_steps=6,
    )
    rng = np.random.default_rng(0)
    arrays = [
        (rng.uniform(-0.4, 0.4, (c.n_in, c.n_out)).astype(np.float32), np.zeros(0, np.float32),
         np.float32(c.threshold))
        for c in net.layers
    ]
    params = tnet.float_params_from_numpy(net, arrays, "cpu")
    spikes = (rng.random((48, 6, 32)) < 0.3).astype(np.uint8)
    ds = tds.SpikeDataset(spikes, rng.integers(0, 4, 48).astype(np.int32), 4, "tiny")
    res = texp.explore_snn(
        net, params, ds,
        search=texp.SearchSpec(
            space=texp.SNNSearchSpace(ff_bits=(2, 4, 6, 8), leak_bits=(1, 3, 8)),
            weights=CostWeights(c_hw=0.4, c_acc=0.4, c_perf=0.2, c_lat=0.4, c_energy=0.4, c_bw=0.2),
            config=TS.AnnealConfig(t_start=1.0, t_min=0.2, alpha=0.5, seed=0),
            population=4,
        ),
        evaluate=texp.EvalSpec(batch=24),
    )
    return res.to_json()


WORKER = """
import json, sys
sys.path[:0] = [sys.argv[4], sys.argv[5]]
import torch
torch.set_num_threads(1)
from repro_torch.distributed import compat
from test_torch_distributed import search
rank = int(sys.argv[1])
assert compat.maybe_init_distributed("file://" + sys.argv[2], 2, rank)
assert compat.process_count() == 2 and compat.process_index() == rank
out = search()
with open(sys.argv[3], "w") as f:
    json.dump({"rank": rank, "hosts": compat.process_count(), "json": out}, f, sort_keys=True)
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


def test_two_process_gloo_explore_snn_equals_one_process(no_coordinator, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    rdv = tmp_path / "rendezvous"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), str(rdv), str(tmp_path / f"r{rank}.json"),
             str(ROOT / "src"), str(ROOT / "tests")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in (0, 1)
    ]
    try:
        errs = [p.communicate(timeout=WALL_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    got = [json.loads((tmp_path / f"r{rank}.json").read_text()) for rank in (0, 1)]
    assert [g["hosts"] for g in got] == [2, 2]
    one = json.loads(json.dumps(search(), sort_keys=True))
    assert got[0]["json"] == one
    assert got[1]["json"] == one  # every process gathers the whole sweep
