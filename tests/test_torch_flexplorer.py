"""The port's Flex-plorer against JAX's: same searches, same results.

The strategies (numpy, copied) on a synthetic accuracy surface, and
``explore_snn`` end to end on the tiny network of ``tests/test_strategies.py``
with the event-aware perf and bandwidth terms on (``c_perf > 0``, ``c_bw >
0``), so each candidate's float32 traffic stats reach the objectives: serial
anneal, population anneal and NSGA-II give the same ``to_json()``, best and
report in both packages.  Also the port's kill-and-resume, the legacy shim,
the refusals of what is not ported yet (and of a refine phase without its
training data), and its checkpointer.
"""

import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core.flexplorer import cost as jcost
from repro.core.flexplorer import explorer as jexp
from repro.core.flexplorer import strategies as JS
from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.data.snn_datasets import mnist_like
from repro_torch.checkpoint.checkpointer import CheckpointCorruptError, Checkpointer, latest_step
from repro_torch.core import network as tnet
from repro_torch.core import shard
from repro_torch.core import snn_layer as tsl
from repro_torch.core.flexplorer import annealer as tann
from repro_torch.core.flexplorer import cost as tcost
from repro_torch.core.flexplorer import explorer as texp
from repro_torch.core.flexplorer import strategies as TS
from repro_torch.data import snn_datasets as tds

# ---------------------------------------------------------------------------
# Strategies on a synthetic surface (host only)
# ---------------------------------------------------------------------------

KNOBS = {"a": (2, 4, 6, 8), "b": (1, 3, 5), "c": (0, 1)}


def _hw(cfg):
    return (cfg[0] + cfg[1] + cfg[2]) / 20.0


def _acc(cfg):
    return 1.0 - abs(cfg[0] - 6) / 10.0 - abs(cfg[1] - 3) / 10.0 + cfg[2] / 50.0


def _acc_cost(a):
    return 0.5 * (1.0 - a)


STRATEGY_CASES = {
    "anneal-serial": lambda S: S.AnnealStrategy(
        KNOBS, S.AnnealConfig(t_start=1.0, t_min=0.05, alpha=0.6, seed=3)
    ),
    "anneal-pop": lambda S: S.PopulationAnnealStrategy(
        KNOBS, S.AnnealConfig(t_start=1.0, t_min=0.05, alpha=0.6, seed=3), population=4
    ),
    "nsga2": lambda S: S.NSGAStrategy(KNOBS, S.NSGAConfig(population=8, generations=5, seed=3)),
}


@pytest.mark.parametrize("name", sorted(STRATEGY_CASES))
def test_strategies_match_jax(name):
    results = [
        S.run_search(STRATEGY_CASES[name](S), KNOBS, _hw, lambda b: [_acc(c) for c in b], _acc_cost)
        for S in (JS, TS)
    ]
    want, got = (json.dumps(r.to_json(), sort_keys=True) for r in results)
    assert got == want
    assert results[0].front == results[1].front and results[0].best == results[1].best


def test_annealer_alias_module_matches():
    cfg = TS.AnnealConfig(t_start=1.0, t_min=0.1, alpha=0.5, seed=1)
    res = tann.simulated_annealing(KNOBS, _hw, _acc, _acc_cost, cfg)
    direct = TS.run_search(
        TS.AnnealStrategy(KNOBS, cfg), KNOBS, _hw, lambda b: [_acc(c) for c in b], _acc_cost
    )
    assert tann.AnnealResult is TS.SearchResult
    assert res.to_json() == direct.to_json()


# ---------------------------------------------------------------------------
# explore_snn, end to end
# ---------------------------------------------------------------------------

WEIGHTS = dict(c_hw=0.4, c_acc=0.4, c_perf=0.2, c_lat=0.4, c_energy=0.4, c_bw=0.2)


def _nets(topology="ff"):
    def mk(sl, nw):
        return nw.NetworkConfig(
            layers=(
                sl.LayerConfig(n_in=32, n_out=16, neuron=sl.NeuronModel.LIF,
                               topology=sl.Topology(topology), reset=sl.ResetMode.SUBTRACT,
                               beta=0.9),
                sl.LayerConfig(n_in=16, n_out=4, neuron=sl.NeuronModel.LIF,
                               reset=sl.ResetMode.SUBTRACT, beta=0.77),
            ),
            n_steps=6,
        )
    return mk(jsl, jnet), mk(tsl, tnet)


def _setup(topology="ff"):
    """The tiny net of tests/test_strategies.py: JAX's float parameters carried
    over through numpy, one mnist_like set for both packages."""
    jn, tn = _nets(topology)
    jp = jnet.init_float_params(jax.random.PRNGKey(1), jn)
    tp = tnet.float_params_from_numpy(tn, [tuple(np.asarray(a) for a in p) for p in jp], "cpu")
    ds = mnist_like(n=64, T=6, seed=6)
    ds.spikes = ds.spikes[:, :, :32]
    ds.labels = ds.labels % 4
    return (jn, jp, ds), (tn, tp, tds.SpikeDataset(ds.spikes, ds.labels, ds.n_classes, ds.name))


@pytest.fixture(scope="module")
def tiny():
    return _setup()


def _spec(S, E, kind):
    space = E.SNNSearchSpace(ff_bits=(2, 4, 6, 8, 12), rec_bits=(3, 6, 16), leak_bits=(1, 3, 8))
    if kind == "nsga2":
        return dict(space=space, strategy="nsga2",
                    config=S.NSGAConfig(population=8, generations=3, seed=0))
    if kind == "anneal-pop":
        return dict(space=space, population=4,
                    config=S.AnnealConfig(t_start=1.0, t_min=0.2, alpha=0.5, seed=0))
    return dict(space=space, config=S.AnnealConfig(t_start=1.0, t_min=0.3, alpha=0.5, seed=0))


def _explore_both(kind, setup):
    (jn, jp, jds_), (tn, tp, tds_) = setup
    jr = jexp.explore_snn(
        jn, jp, jds_,
        search=jexp.SearchSpec(weights=jcost.CostWeights(**WEIGHTS), **_spec(JS, jexp, kind)),
        evaluate=jexp.EvalSpec(batch=32),
    )
    tr = texp.explore_snn(
        tn, tp, tds_,
        search=texp.SearchSpec(weights=tcost.CostWeights(**WEIGHTS), **_spec(TS, texp, kind)),
        evaluate=texp.EvalSpec(batch=32),
    )
    return jr, tr


@pytest.mark.parametrize("kind", ["anneal-serial", "anneal-pop", "nsga2"])
def test_explore_snn_matches_jax(tiny, kind):
    jr, tr = _explore_both(kind, tiny)
    assert json.dumps(tr.to_json(), sort_keys=True) == json.dumps(jr.to_json(), sort_keys=True)
    assert tr.search.best == jr.search.best
    assert tr.report() == jr.report()
    assert tr.search.trace and all("bw_congestion" in t for t in tr.search.trace)
    for a, b in zip(tr.best_qparams, jr.best_qparams):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_explore_snn_recurrent_nsga_matches_jax():
    """An ATA-F hidden layer (three knobs, rec_bits up to 16) under NSGA-II."""
    jr, tr = _explore_both("nsga2", _setup("ata_f"))
    assert json.dumps(tr.to_json(), sort_keys=True) == json.dumps(jr.to_json(), sort_keys=True)
    assert "rec_bits" in tr.search.best_breakdown


def test_explore_snn_kill_and_resume_identical_front(tiny, tmp_path, monkeypatch):
    _, (tn, tp, tds_) = tiny
    spec = dict(
        space=texp.SNNSearchSpace(ff_bits=(2, 3, 4, 6, 8), leak_bits=(2, 3, 8)),
        strategy="nsga2",
        config=TS.NSGAConfig(population=8, generations=3, seed=0),
        weights=tcost.CostWeights(**WEIGHTS),
    )
    ev = texp.EvalSpec(batch=32)
    full = texp.explore_snn(
        tn, tp, tds_, search=texp.SearchSpec(**spec, checkpoint_dir=str(tmp_path / "full")),
        evaluate=ev,
    )
    real_sweep = texp.eval_int_population
    calls = {"n": 0}

    def dies_mid_generation(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("killed mid-generation")
        return real_sweep(*args, **kw)

    monkeypatch.setattr(texp, "eval_int_population", dies_mid_generation)
    with pytest.raises(RuntimeError, match="killed"):
        texp.explore_snn(
            tn, tp, tds_, search=texp.SearchSpec(**spec, checkpoint_dir=str(tmp_path / "killed")),
            evaluate=ev,
        )
    assert calls["n"] == 2
    assert latest_step(tmp_path / "killed") is not None
    monkeypatch.setattr(texp, "eval_int_population", real_sweep)
    resumed = texp.explore_snn(
        tn, tp, tds_, search=texp.SearchSpec(**spec, checkpoint_dir=str(tmp_path / "killed")),
        evaluate=ev,
    )
    assert resumed.search.front == full.search.front
    assert resumed.search.best == full.search.best
    assert resumed.search.trace == full.search.trace
    assert resumed.to_json() == full.to_json()


def test_legacy_kwargs_shim_warns_once_and_matches(tiny):
    _, (tn, tp, tds_) = tiny
    space = texp.SNNSearchSpace(ff_bits=(4, 6, 8), leak_bits=(3, 8))
    cfg = TS.AnnealConfig(t_start=1.0, t_min=0.2, alpha=0.5, seed=0)
    texp._LEGACY_WARNED = False
    with pytest.warns(DeprecationWarning, match="migration table"):
        legacy = texp.explore_snn(tn, tp, tds_, space=space, anneal_cfg=cfg, eval_batch=32,
                                  population=4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        texp.explore_snn(tn, tp, tds_, space=space, anneal_cfg=cfg, eval_batch=32, population=4)
    assert not [w for w in caught if issubclass(w.category, DeprecationWarning)]
    modern = texp.explore_snn(
        tn, tp, tds_, search=texp.SearchSpec(space=space, config=cfg, population=4),
        evaluate=texp.EvalSpec(batch=32),
    )
    assert legacy.search.best == modern.search.best
    assert legacy.search.cache == modern.search.cache
    with pytest.raises(TypeError, match="both search="):
        texp.explore_snn(tn, tp, tds_, search=texp.SearchSpec(), space=space)
    with pytest.raises(TypeError, match="unexpected keyword"):
        texp.explore_snn(tn, tp, tds_, annealing_config=None)


@pytest.mark.parametrize("case", ["mesh-2", "mesh-auto", "refine"])
def test_unported_phases_raise(tiny, case):
    """The phases the port once refused.  ``evaluate.mesh`` is ported: a
    count beyond the devices there are raises JAX's ``make_mesh`` error, and
    ``"auto"`` runs (on a host with one device, the serial search verbatim:
    the same ``to_json()`` as ``mesh=None``).  The refine phase is ported:
    without its training data it raises JAX's ValueError."""
    _, (tn, tp, tds_) = tiny
    if case == "mesh-2":
        with pytest.raises(ValueError, match="exceeds"):
            texp.explore_snn(tn, tp, tds_, evaluate=texp.EvalSpec(mesh=shard.make_mesh().n_shards + 1))
    elif case == "mesh-auto":
        space = texp.SNNSearchSpace(ff_bits=(4, 6), leak_bits=(3, 8))
        cfg = TS.AnnealConfig(t_start=1.0, t_min=0.3, alpha=0.5, seed=0)
        spec = texp.SearchSpec(space=space, config=cfg, population=2)
        auto = texp.explore_snn(tn, tp, tds_, search=spec, evaluate=texp.EvalSpec(batch=32, mesh="auto"))
        plain = texp.explore_snn(tn, tp, tds_, search=spec, evaluate=texp.EvalSpec(batch=32))
        if shard.make_mesh().n_shards == 1:
            assert json.dumps(auto.to_json(), sort_keys=True) == json.dumps(plain.to_json(), sort_keys=True)
    else:
        with pytest.raises(ValueError, match="refine_train_ds"):
            texp.explore_snn(tn, tp, tds_, refine=texp.RefineSpec(top_k=2))


def test_population_backend_warning(tiny):
    from repro_torch.core.backend import FusedBackend, ReferenceBackend

    _, (tn, tp, tds_) = tiny
    spec = texp.SearchSpec(
        space=texp.SNNSearchSpace(ff_bits=(4, 6), leak_bits=(3, 8)),
        config=TS.AnnealConfig(t_start=1.0, t_min=0.3, alpha=0.5, seed=0), population=2,
    )
    for backend, warns in ((ReferenceBackend(), False), (FusedBackend(), True)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = texp.explore_snn(tn, tp, tds_, search=spec,
                                   evaluate=texp.EvalSpec(batch=32, backend=backend))
        assert bool([w for w in caught if "ignored" in str(w.message)]) == warns
    out = res.to_json()
    json.dumps(out)
    assert res.anneal is res.search and out["refined"] == [] and out["refined_front"] is None


# ---------------------------------------------------------------------------
# The checkpointer
# ---------------------------------------------------------------------------


def test_checkpointer_round_trips_tensors_and_arrays(tmp_path):
    layer = tsl.LayerState(
        u=torch.arange(6, dtype=torch.int32).reshape(2, 3),
        i_syn=torch.zeros(2, 3, dtype=torch.int32),
        prev_spk=torch.ones(2, 3, dtype=torch.int32),
    )
    tree = {"round": np.int64(7), "layers": [layer], "scale": np.float32(0.25)}
    ck = Checkpointer(tmp_path, keep=2)
    for step in (1, 2, 3):
        ck.save(step, tree, user_state={"step": step})
    ck.wait()
    assert latest_step(tmp_path) == 3
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000002", "step_00000003"]
    back, state = ck.restore(tree)
    assert state == {"step": 3}
    assert isinstance(back["layers"][0], tsl.LayerState)
    for a, b in zip(back["layers"][0], layer):
        assert isinstance(a, torch.Tensor) and torch.equal(a, b)
    assert back["round"] == 7 and back["scale"] == np.float32(0.25)
    # a flipped byte in the stored leaf is refused
    import zipfile

    npz = tmp_path / "step_00000003" / "arrays.npz"
    with zipfile.ZipFile(npz) as z:
        members = {n: z.read(n) for n in z.namelist()}
    name = "layers::0::u.npy"
    members[name] = members[name][:-1] + bytes([members[name][-1] ^ 1])
    with zipfile.ZipFile(npz, "w") as z:
        for n, data in members.items():
            z.writestr(n, data)
    with pytest.raises(CheckpointCorruptError, match="CRC"):
        ck.restore(tree)
