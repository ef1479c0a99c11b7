"""The port's sharded paths against its serial paths and JAX's, exactly.

The port's counterpart of ``tests/test_shard.py``.  Meshes name the CPU
several times (``make_mesh(4, devices=[cpu] * 4)``; 3 shards for ragged
remainders), which partitions, pads and reassembles exactly as four devices
would.  Every sharded integer result -- records, accuracies, event
statistics, ``explore_snn`` scores, served and streamed counts -- equals the
port's serial path and the JAX package's serial output on the same numpy
inputs, bit for bit.  JAX's own ``tests/test_shard.py`` holds JAX's sharded
path to its serial one.  Sizes stay small (widths <= 32, T <= 8).
"""

import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import backend as jbe
from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.core.flexplorer import explorer as jexp
from repro.core.flexplorer import strategies as JS
from repro.core.flexplorer.cost import CostWeights as JWeights
from repro.data.snn_datasets import mnist_like
from repro.snn import train as jtrain
from repro.snn.surrogate import fast_sigmoid as jfast_sigmoid
from repro_torch.core import backend as tbe
from repro_torch.core import network as tnet
from repro_torch.core import shard
from repro_torch.core import snn_layer as tsl
from repro_torch.core.flexplorer import explorer as texp
from repro_torch.core.flexplorer import strategies as TS
from repro_torch.core.flexplorer.cost import CostWeights as TWeights
from repro_torch.data import snn_datasets as tds
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.snn_engine import SNNRequest, SNNServeEngine
from repro_torch.serve.streaming import StreamConfig, StreamSessionManager
from repro_torch.serve.supervisor import SupervisedEngine
from repro_torch.snn import qat as tqat
from repro_torch.snn import train as ttrain
from repro_torch.snn.surrogate import fast_sigmoid

CPU = torch.device("cpu")
WEIGHTS = dict(c_hw=0.4, c_acc=0.4, c_perf=0.2, c_lat=0.4, c_energy=0.4, c_bw=0.2)


def cpu_mesh(n):
    return shard.make_mesh(n, devices=[CPU] * n)


def _nets(topology="ff", neuron="lif", n_in=32, hidden=16, n_out=4, T=6):
    def mk(sl, nw):
        return nw.NetworkConfig(
            layers=(
                sl.LayerConfig(n_in=n_in, n_out=hidden, neuron=sl.NeuronModel(neuron), w_bits=6,
                               u_bits=16, topology=sl.Topology(topology),
                               reset=sl.ResetMode.SUBTRACT, beta=0.9, alpha=0.8),
                sl.LayerConfig(n_in=hidden, n_out=n_out, neuron=sl.NeuronModel(neuron), w_bits=6,
                               u_bits=16, beta=0.77),
            ),
            n_steps=T,
        )
    return mk(jsl, jnet), mk(tsl, tnet)


def _params(jn, tn, seed=0):
    """JAX's float and quantized parameters, carried to the port through numpy."""
    jp = jnet.init_float_params(jax.random.PRNGKey(seed), jn)
    jq, _ = jnet.quantize_params(jn, jp)
    tp = tnet.float_params_from_numpy(tn, [tuple(np.asarray(a) for a in p) for p in jp], "cpu")
    tq = tnet.int_params_from_numpy(tn, [tuple(np.asarray(a) for a in p) for p in jq], "cpu")
    return (jp, jq), (tp, tq)


def _spikes(T, B, n_in=32, seed=1, rate=0.3):
    return (np.random.default_rng(seed).random((T, B, n_in)) < rate).astype(np.int32)


def _dataset(n=50, T=6, n_in=32, n_classes=4, seed=3):
    ds = mnist_like(n=n, T=T, seed=seed)
    spikes, labels = ds.spikes[:, :, :n_in], ds.labels % n_classes
    ds.spikes, ds.labels = spikes, labels
    return ds, tds.SpikeDataset(spikes, labels, ds.n_classes, ds.name)


def _assert_record(got, want):
    """A port record equals another port record or a JAX record exactly."""
    as_np = lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(as_np(got.spike_counts), as_np(want.spike_counts))
    assert len(got.layer_spikes) == len(want.layer_spikes)
    for x, y in zip(got.layer_spikes, want.layer_spikes):
        np.testing.assert_array_equal(as_np(x), as_np(y))
    np.testing.assert_array_equal(as_np(got.input_events), as_np(want.input_events))


def _assert_stats(a, b):
    np.testing.assert_array_equal(a["input_events_per_step"], b["input_events_per_step"])
    for x, y in zip(a["layer_events_per_step"], b["layer_events_per_step"]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Mesh plumbing
# ---------------------------------------------------------------------------


def test_make_mesh_and_resolve():
    local = shard.make_mesh()
    n_local = local.n_shards
    assert n_local == max(1, torch.cuda.device_count())
    assert shard.make_mesh(1).n_shards == 1  # one device: the serial fallback
    assert shard.resolve_mesh(None) is None
    assert shard.resolve_mesh("auto") == local
    assert shard.resolve_mesh(1).n_shards == 1
    dm = cpu_mesh(4)
    assert shard.resolve_mesh(dm) is dm
    assert dm.n_shards == 4 and dm.devices == (CPU,) * 4  # a device may repeat
    with pytest.raises(ValueError, match="exceeds"):
        shard.make_mesh(n_local + 1)
    with pytest.raises(ValueError, match="exceeds"):
        shard.make_mesh(5, devices=[CPU] * 4)
    with pytest.raises(ValueError, match=">= 1"):
        shard.make_mesh(0)
    with pytest.raises(ValueError, match="cannot interpret"):
        shard.resolve_mesh(3.5)
    with pytest.raises(ValueError, match="cannot interpret"):
        shard.resolve_mesh(True)
    assert shard.make_mesh(2, devices=["cpu"] * 3, axis="lanes").axis == "lanes"


def test_device_mesh_is_hashable():
    assert hash(cpu_mesh(4)) == hash(cpu_mesh(4)) and cpu_mesh(4) == cpu_mesh(4)
    assert {cpu_mesh(4): 1}[cpu_mesh(4)] == 1
    assert cpu_mesh(3) != cpu_mesh(4)
    assert cpu_mesh(4).pad(23) == 1 and cpu_mesh(3).pad(5) == 1 and cpu_mesh(4).pad(8) == 0


def test_pad_to_shards_modes():
    dm = cpu_mesh(4)
    x = torch.arange(2 * 5 * 3).reshape(2, 5, 3)
    padded = shard.pad_to_shards(x, dm, axis=1)
    assert padded.shape == (2, 8, 3)
    assert torch.equal(padded[:, :5], x) and not padded[:, 5:].any()
    edge = shard.pad_to_shards(x, dm, axis=1, mode="edge")
    assert edge.shape == (2, 8, 3)
    for j in range(5, 8):
        assert torch.equal(edge[:, j], x[:, -1])
    assert shard.pad_to_shards(x, cpu_mesh(5), axis=1) is x  # already divisible


def test_split_places_contiguous_slices_and_join_reassembles():
    """A sample-axis slice of a [T, B, n] raster is a strided view; every
    shard's slice is made contiguous (the CUDA kernels refuse strides)."""
    dm = cpu_mesh(4)
    x = torch.arange(3 * 8 * 2).reshape(3, 8, 2)
    parts = shard.split(x, dm, axis=1)
    assert [p.shape for p in parts] == [(3, 2, 2)] * 4
    assert all(p.is_contiguous() for p in parts)
    assert torch.equal(shard.join(parts, dm, axis=1), x)
    reps = shard.replicate([tsl.IntLayerParams(x, x, x)], dm)
    assert len(reps) == 4 and all(r is reps[0] for r in reps)  # one copy per distinct device


# ---------------------------------------------------------------------------
# Sample-axis parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [4, 3])
@pytest.mark.parametrize("batch", [8, 7], ids=["even", "ragged"])
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_run_int_sharded_bit_exact(batch, backend, n_shards):
    jn, tn = _nets()
    (_, jq), (_, tq) = _params(jn, tn)
    x = _spikes(6, batch)
    want = jnet.run_int(jn, jq, x)
    serial = tnet.run_int(tn, tq, torch.from_numpy(x), backend=backend)
    got = shard.run_int_sharded(tn, tq, torch.from_numpy(x), cpu_mesh(n_shards), backend=backend)
    _assert_record(got, serial)
    _assert_record(got, want)


@pytest.mark.parametrize(
    "topology,neuron", [("ata_f", "lif"), ("ff", "synaptic"), ("ata_t", "if")]
)
def test_run_int_sharded_recurrent_and_synaptic(topology, neuron):
    jn, tn = _nets(topology, neuron)
    (_, jq), (_, tq) = _params(jn, tn)
    x = _spikes(6, 5, seed=4)
    got = shard.run_int_sharded(tn, tq, torch.from_numpy(x), cpu_mesh(4), backend="fused")
    _assert_record(got, tnet.run_int(tn, tq, torch.from_numpy(x)))
    _assert_record(got, jnet.run_int(jn, jq, x))


def test_run_int_sharded_event_backend_shards_or_warns(monkeypatch):
    """event x mesh: auto / gather shard through the pallas surrogate, every
    shard's layer 0 through the sparse path at one budget measured from the
    whole raster; explicit pallas shards as it is; only an explicit csr
    gives the mesh up -- with a warning, and only when a real multi-shard
    partition is abandoned."""
    jn, tn = _nets(n_in=64)
    (_, jq), (_, tq) = _params(jn, tn)
    x = _spikes(6, 8, n_in=64, rate=0.05)
    x[:, 7, :16], x[:, 7, 16:] = 1, 0  # the last shard holds the raster's densest rows
    xt = torch.from_numpy(x)
    want = jnet.run_int(jn, jq, x)
    for backend in ["event", tbe.EventBackend("csr")]:  # a 1-shard mesh: silent, serial
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _assert_record(shard.run_int_sharded(tn, tq, xt, 1, backend=backend), want)

    calls = []
    real = tbe.sparse_accum_currents

    def recording(raster, w_ff, budget, **kw):
        calls.append((raster.shape[1], budget))
        return real(raster, w_ff, budget, **kw)

    monkeypatch.setattr(tbe, "sparse_accum_currents", recording)
    for backend in [
        "event",
        tbe.EventBackend("gather", capacity_multiple=4),
        tbe.EventBackend("auto", capacity_multiple=4),
        tbe.EventBackend("pallas"),
    ]:
        calls.clear()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            rec = shard.run_int_sharded(tn, tq, xt, cpu_mesh(4), backend=backend)
        _assert_record(rec, want)
        assert [b for b, _ in calls] == [2, 2, 2, 2]  # layer 0 sparse on every shard
        if not isinstance(backend, tbe.EventBackend) or backend.strategy != "pallas":
            assert {k for _, k in calls} == {16}  # the whole raster's budget
    with pytest.warns(UserWarning, match="mesh ignored"):
        rec = shard.run_int_sharded(tn, tq, xt, cpu_mesh(4), backend=tbe.EventBackend("csr"))
    _assert_record(rec, want)


def test_run_float_sharded_matches_serial():
    """The float simulation per shard: exact on this CPU (each sample's f32
    trajectory is computed alone; the products here sum in the same order
    for 2 rows as for 7)."""
    jn, tn = _nets()
    (jp, _), (tp, _) = _params(jn, tn)
    x = _spikes(6, 7).astype(np.float32)
    want = jnet.run_float(jn, jp, x, jfast_sigmoid(25.0))
    serial = tnet.run_float(tn, tp, torch.from_numpy(x), fast_sigmoid(25.0))
    got = shard.run_float_sharded(tn, tp, torch.from_numpy(x), fast_sigmoid(25.0), cpu_mesh(4))
    _assert_record(got, serial)
    np.testing.assert_array_equal(got.predictions().numpy(), np.asarray(want.predictions()))


@pytest.mark.parametrize("n_shards", [4, 3])
@pytest.mark.parametrize("backend", ["reference", "fused", "event"])
def test_eval_int_mesh_matches_serial_and_jax(backend, n_shards):
    """50 samples at batch 24: a ragged final batch and ragged shards; the
    statistics come from the reassembled batch, so they are JAX's bits."""
    jn, tn = _nets()
    (_, jq), (_, tq) = _params(jn, tn)
    jds_, tds_ = _dataset()
    acc_j, st_j = jtrain.eval_int(jn, jq, jds_, batch_size=24, return_stats=True)
    acc_s, st_s = ttrain.eval_int(tn, tq, tds_, batch_size=24, return_stats=True, backend=backend)
    acc_m, st_m = ttrain.eval_int(
        tn, tq, tds_, batch_size=24, return_stats=True, backend=backend, mesh=cpu_mesh(n_shards)
    )
    assert acc_m == acc_s == acc_j
    _assert_stats(st_m, st_s)
    _assert_stats(st_m, st_j)


def test_eval_int_event_csr_mesh_warns_and_matches():
    jn, tn = _nets()
    (_, jq), (_, tq) = _params(jn, tn)
    jds_, tds_ = _dataset(n=24)
    serial = ttrain.eval_int(tn, tq, tds_, batch_size=12, backend="event")
    with pytest.warns(UserWarning, match="mesh ignored"):
        csr = ttrain.eval_int(
            tn, tq, tds_, batch_size=12, backend=tbe.EventBackend("csr"), mesh=cpu_mesh(4)
        )
    assert serial == csr == jtrain.eval_int(jn, jq, jds_, batch_size=12)


def test_eval_float_mesh_matches_serial():
    jn, tn = _nets()
    (jp, _), (tp, _) = _params(jn, tn)
    jds_, tds_ = _dataset(seed=4)
    want = jtrain.eval_float(jn, jp, jds_, batch_size=24)
    assert ttrain.eval_float(tn, tp, tds_, batch_size=24) == want
    for n in (4, 3):
        assert ttrain.eval_float(tn, tp, tds_, batch_size=24, mesh=cpu_mesh(n)) == want


# ---------------------------------------------------------------------------
# Candidate-axis parity (the DSE fan-out)
# ---------------------------------------------------------------------------

# (w_bits, w_rec_bits, leak_bits) of each candidate
CANDIDATES = [(4, 4, 3), (6, 6, 8), (8, 8, 8), (5, 5, 4), (16, 2, 1)]


@pytest.mark.parametrize("n_cands,n_shards", [(4, 4), (3, 4), (5, 4), (5, 3)])
def test_eval_int_population_mesh_matches_serial(n_cands, n_shards):
    """Edge-padded candidates (theta and decay registers included) are
    sliced off; every candidate equals the one-device sweep, JAX's sweep
    and serial eval_int."""
    jn, tn = _nets("ata_f")
    (jp, _), (tp, _) = _params(jn, tn)
    jds_, tds_ = _dataset(n=48, seed=5)
    picks = CANDIDATES[:n_cands]
    jc = [jn.replace_precisions(w_bits=w, w_rec_bits=r, leak_bits=l) for w, r, l in picks]
    tc = [tn.replace_precisions(w_bits=w, w_rec_bits=r, leak_bits=l) for w, r, l in picks]
    jqs = [jnet.quantize_params(c, jp)[0] for c in jc]
    tqs = [tnet.quantize_params(c, tp)[0] for c in tc]
    pj, sj = jtrain.eval_int_population(jn, jc, jqs, jds_, batch_size=24, return_stats=True)
    ps, ss = ttrain.eval_int_population(tn, tc, tqs, tds_, batch_size=24, return_stats=True)
    pm, sm = ttrain.eval_int_population(
        tn, tc, tqs, tds_, batch_size=24, return_stats=True, mesh=cpu_mesh(n_shards)
    )
    np.testing.assert_array_equal(pm, ps)
    np.testing.assert_array_equal(pm, np.asarray(pj))
    assert len(sm) == n_cands
    for a, b, c in zip(sm, ss, sj):
        _assert_stats(a, b)
        _assert_stats(a, c)
    serial = [ttrain.eval_int(c, q, tds_, batch_size=24) for c, q in zip(tc, tqs)]
    np.testing.assert_array_equal(serial, pm)


def test_run_int_population_sharded_pads_registers():
    """The sharded sweep of 5 candidates on 4 shards: counts and emitted
    totals equal the one-device sweep, the three padded lanes gone."""
    jn, tn = _nets("ff", "lif")
    (_, _), (tp, _) = _params(jn, tn)
    tc = [tn.replace_precisions(w_bits=w, w_rec_bits=r, leak_bits=l) for w, r, l in CANDIDATES]
    tqs = [tnet.quantize_params(c, tp)[0] for c in tc]
    stacked, b, a = tbe.stack_population(tc, tqs)
    x = torch.from_numpy(_spikes(6, 9, seed=8))
    want = tbe.run_int_population(tn, stacked, b, a, x, return_events=True)
    got = shard.run_int_population_sharded(tn, stacked, b, a, x, cpu_mesh(4), return_events=True)
    assert got[0].shape[0] == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    only = shard.run_int_population_sharded(tn, stacked, b, a, x, cpu_mesh(4))
    assert torch.equal(only, want[0])


def _explore_pair(kind, setup, mesh):
    (jn, jp, jds_), (tn, tp, tds_) = setup
    space = dict(ff_bits=(2, 4, 6, 8, 12), rec_bits=(3, 6, 16), leak_bits=(1, 3, 8))
    if kind == "nsga2":
        spec = lambda S, E: dict(strategy="nsga2", config=S.NSGAConfig(population=8, generations=3, seed=0))
    elif kind == "anneal-pop":
        spec = lambda S, E: dict(population=4, config=S.AnnealConfig(t_start=1.0, t_min=0.2, alpha=0.5, seed=0))
    else:
        spec = lambda S, E: dict(config=S.AnnealConfig(t_start=1.0, t_min=0.3, alpha=0.5, seed=0))
    jr = jexp.explore_snn(
        jn, jp, jds_,
        search=jexp.SearchSpec(space=jexp.SNNSearchSpace(**space), weights=JWeights(**WEIGHTS),
                               **spec(JS, jexp)),
        evaluate=jexp.EvalSpec(batch=32),
    )
    tr = texp.explore_snn(
        tn, tp, tds_,
        search=texp.SearchSpec(space=texp.SNNSearchSpace(**space), weights=TWeights(**WEIGHTS),
                               **spec(TS, texp)),
        evaluate=texp.EvalSpec(batch=32, mesh=mesh),
    )
    return jr, tr


@pytest.fixture(scope="module")
def dse_setup():
    jn, tn = _nets()
    (jp, _), (tp, _) = _params(jn, tn, seed=1)
    jds_, tds_ = _dataset(n=64, seed=6)
    return (jn, jp, jds_), (tn, tp, tds_)


@pytest.mark.parametrize("kind", ["anneal-serial", "anneal-pop", "nsga2"])
def test_explore_snn_mesh_matches_jax(dse_setup, kind):
    """A 4-shard search (serial anneal: each candidate's eval_int sharded;
    population anneal and NSGA-II: the sweeps' candidate axis sharded, the
    populations multiples of 4 so the sweep widths do not move) gives JAX's
    serial search's to_json(), perf and bandwidth terms on."""
    jr, tr = _explore_pair(kind, dse_setup, cpu_mesh(4))
    assert json.dumps(tr.to_json(), sort_keys=True) == json.dumps(jr.to_json(), sort_keys=True)
    assert tr.search.best == jr.search.best


def test_refine_candidates_mesh_matches_serial():
    """tests/test_qat.py's trained 256-32-10 net and three low-bit finalists,
    refined on 2 shards (edge-padded to 4) and on 3: scores, history and
    refined float weights equal the port's serial refine bit for bit, and
    the scores and history equal JAX's serial refine exactly.  The weights
    are held to JAX's within the JAX training tests' 1e-3 of max |w| (two
    frameworks' float products; 1.1e-7 measured on the CPU).  Each refined
    accuracy equals serial eval_int of the refined weights."""
    from repro.data import snn_datasets as jds
    from repro.snn import qat as jqat

    def mk(sl, nw):
        return nw.NetworkConfig(
            layers=(sl.LayerConfig(n_in=256, n_out=32, w_bits=6, u_bits=16),
                    sl.LayerConfig(n_in=32, n_out=10, w_bits=6, u_bits=16)),
            n_steps=10, name="qat-tiny",
        )

    jn, tn = mk(jsl, jnet), mk(tsl, tnet)
    jtr, jte = jds.mnist_like(n=256, T=10, seed=11).split()
    ttr, tte = tds.mnist_like(n=256, T=10, seed=11).split()
    jp = jtrain.train_snn(jn, jtr, epochs=2, batch_size=64).params
    tp = tnet.float_params_from_numpy(tn, [tuple(np.asarray(a) for a in p) for p in jp], "cpu")
    picks = [(2, 3), (3, 3), (4, 8)]
    jc = [jn.replace_precisions(w_bits=w, leak_bits=l) for w, l in picks]
    tc = [tn.replace_precisions(w_bits=w, leak_bits=l) for w, l in picks]
    kw = dict(epochs=2, batch_size=64, eval_batch=128)
    want = jqat.refine_candidates(jn, jc, jp, jtr, jte, **kw)
    serial = tqat.refine_candidates(tn, tc, tp, ttr, tte, **kw)
    np.testing.assert_array_equal(serial.base_acc, want.base_acc)
    np.testing.assert_array_equal(serial.best_acc, want.best_acc)
    assert serial.history == want.history
    moved = [any(not torch.equal(x, y) for a, b in zip(q, tp) for x, y in zip(a, b))
             for q in serial.params]
    assert any(moved), "no finalist's best checkpoint left the PTQ weights"
    for n in (2, 3):
        got = tqat.refine_candidates(tn, tc, tp, ttr, tte, mesh=cpu_mesh(n), **kw)
        np.testing.assert_array_equal(got.base_acc, want.base_acc)
        np.testing.assert_array_equal(got.best_acc, want.best_acc)
        assert got.history == want.history
        assert len(got.params) == 3
        for k, cand in enumerate(tc):
            qp, _ = tnet.quantize_params(cand, got.params[k])
            assert ttrain.eval_int(cand, qp, tte, batch_size=128) == got.best_acc[k]
            for a, b, c in zip(got.params[k], serial.params[k], want.params[k]):
                for x, y, z in zip(a, b, c):
                    assert x.device == CPU
                    assert torch.equal(x, y)
                    z = np.asarray(z)
                    if z.size:
                        assert np.abs(x.numpy() - z).max() <= 1e-3 * np.abs(z).max()


# ---------------------------------------------------------------------------
# Ragged batched runner parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [4, 3])
@pytest.mark.parametrize("batch", [8, 5], ids=["even", "ragged"])
def test_run_int_batched_mesh_matches_serial(batch, n_shards):
    jn, tn = _nets(T=8)
    (_, jq), (_, tq) = _params(jn, tn)
    x = _spikes(8, batch, seed=5, rate=0.25)
    lens = np.asarray([8, 3, 5, 1, 7, 2, 8, 4][:batch], np.int32)
    got = tbe.run_int_batched(tn, tq, x, lens, mesh=cpu_mesh(n_shards))
    _assert_record(got, tbe.run_int_batched(tn, tq, x, lens))
    _assert_record(got, jbe.run_int_batched(jn, jq, x, lens))
    full = tbe.run_int_batched(tn, tq, torch.from_numpy(x), mesh=cpu_mesh(n_shards))
    _assert_record(full, jbe.run_int_batched(jn, jq, x))
    with pytest.raises(ValueError, match="lengths"):
        tbe.run_int_batched(tn, tq, x, lens[:2], mesh=cpu_mesh(n_shards))


# ---------------------------------------------------------------------------
# Sharded serving lanes
# ---------------------------------------------------------------------------


def _serial_counts(tn, tq, raster):
    return tnet.run_int(tn, tq, torch.from_numpy(raster[:, None, :].astype(np.int32))).spike_counts[0].numpy()


def _requests(n, n_in, seed=0, rate=0.3):
    rng = np.random.default_rng(seed)
    return [
        SNNRequest(uid=i, raster=(rng.random((int(rng.integers(2, 9)), n_in)) < rate).astype(np.uint8))
        for i in range(n)
    ]


@pytest.mark.parametrize(
    "backend,rate,route",
    [("reference", 0.3, "lanes"), (tbe.EventBackend("pallas"), 0.05, "event-pallas")],
    ids=["lanes", "event-pallas"],
)
def test_sharded_serve_lanes_bit_exact(backend, rate, route):
    jn, tn = _nets(T=8)
    (_, jq), (_, tq) = _params(jn, tn)
    eng = SNNServeEngine(tn, tq, max_batch=8, data_parallel=cpu_mesh(4), backend=backend,
                         tick_stride=2, device="cpu")
    assert eng.data_parallel == 4 and len(eng._pools) == 4
    assert all(p[0].u.shape[0] == 2 for p in eng._pools)
    reqs = _requests(20, tn.n_in, rate=rate)
    for r in reqs:
        eng.submit(r)
    done = eng.drain()
    assert len(done) == 20
    for r in done:
        np.testing.assert_array_equal(r.spike_counts, _serial_counts(tn, tq, r.raster))
        want = jnet.run_int(jn, jq, r.raster[:, None, :].astype(np.int32))
        np.testing.assert_array_equal(r.spike_counts, np.asarray(want.spike_counts)[0])
        assert r.route == route
    if route == "event-pallas":
        assert eng.metrics.counters.get("tick:sparse", 0) > 0


def test_sharded_serve_data_parallel_clamp_and_refusal():
    """JAX's rules (tests/test_shard.py): over-asks clamp to the devices
    there are -- one for a cpu engine -- then to a divisor of max_batch; a
    count that exists but does not divide max_batch is refused.  A
    DeviceMesh is taken as given, and refused if it cannot split the pool."""
    jn, tn = _nets()
    (_, _), (_, tq) = _params(jn, tn)
    mk = lambda **kw: SNNServeEngine(tn, tq, device="cpu", **kw)
    assert mk(max_batch=8, data_parallel=8).data_parallel == 1  # one cpu device
    assert mk(max_batch=3, data_parallel=2).data_parallel == 1
    assert mk(max_batch=8, data_parallel=None).data_parallel == 1
    assert mk(max_batch=6, data_parallel=cpu_mesh(3)).data_parallel == 3
    assert mk(max_batch=6, data_parallel=cpu_mesh(1)).data_parallel == 1
    with pytest.raises(ValueError, match="divide max_batch"):
        mk(max_batch=5, data_parallel=cpu_mesh(4))
    with pytest.raises(ValueError, match=">= 1"):
        mk(max_batch=4, data_parallel=0)
    with pytest.raises(ValueError, match="device type"):
        mk(max_batch=4, data_parallel=shard.DeviceMesh((torch.device("cuda", 0),) * 2))


def test_sharded_serve_warmup_then_serve():
    jn, tn = _nets(T=8)
    (_, _), (_, tq) = _params(jn, tn)
    eng = SNNServeEngine(tn, tq, max_batch=4, data_parallel=cpu_mesh(4), device="cpu",
                         backend=tbe.EventBackend("pallas"))
    eng.warmup(include_int32=True)
    assert eng.n_served == 0 and not eng.in_flight
    for pool in eng._pools:  # every shard's pool reset
        for st in pool:
            assert all(not a.any() for a in st)
    (req,) = eng.run(_requests(1, tn.n_in, seed=9))
    np.testing.assert_array_equal(req.spike_counts, _serial_counts(tn, tq, req.raster))


def test_sharded_streaming_sessions_equal_serial():
    """Sessions on a four-shard engine: fewer lanes than sessions, so
    carries move between shards across chunks; every readout equals the
    prefix counts of a serial run_int."""
    jn, tn = _nets(T=8)
    (_, _), (_, tq) = _params(jn, tn)
    eng = SNNServeEngine(tn, tq, max_batch=4, data_parallel=cpu_mesh(4), tick_stride=4,
                         device="cpu")
    mgr = StreamSessionManager(eng, config=StreamConfig(window=8, stride=4, idle_budget=None))
    rng = np.random.default_rng(3)
    T = 20
    rasters = {f"s{i}": (rng.random((T, tn.n_in)) < 0.3).astype(np.uint8) for i in range(6)}
    for sid in rasters:
        mgr.open(sid)
    edges = [0, 3, 8, 9, 15, 20]
    for lo, hi in zip(edges[:-1], edges[1:]):
        for sid, r in rasters.items():
            mgr.feed(sid, r[lo:hi])
        mgr.pump()
    for sid, r in rasters.items():
        readouts = mgr.drain_readouts(sid)
        assert [o.t_end for o in readouts] == [4, 8, 12, 16, 20]
        for o in readouts:
            start = max(0, o.t_end - 8)
            want = _serial_counts(tn, tq, r[: o.t_end]).astype(np.int64)
            if start:
                want = want - _serial_counts(tn, tq, r[:start])
            np.testing.assert_array_equal(o.spike_counts, want)


def test_sharded_supervisor_restart_and_quarantine_route_by_slot(tmp_path):
    """A supervised, journaled four-shard engine under a poisoned carry in
    shard 2 (slot 5 of 8) and a kill: the sweep finds that slot, quarantine
    condemns it, the cold restart drops every pool and replays the journal,
    and every result equals serial run_int."""
    jn, tn = _nets(T=8)
    (_, _), (_, tq) = _params(jn, tn)
    inj = FaultInjector().arm("carry", at=1, lane=5, bit=26).arm("kill", at=6)
    factory = lambda: SNNServeEngine(tn, tq, max_batch=8, data_parallel=cpu_mesh(4),
                                     tick_stride=2, device="cpu")
    sup = SupervisedEngine(factory, faults=inj, journal_dir=tmp_path / "wal")
    first = sup.engine
    reqs = _requests(12, tn.n_in, seed=4)
    for r in reqs:
        sup.submit(r)
    done = {}
    for _ in range(1000):
        if not sup.in_flight:
            break
        for r in sup.poll():
            done[r.uid] = r
    assert sorted(done) == list(range(12))
    for r in reqs:
        np.testing.assert_array_equal(done[r.uid].spike_counts, _serial_counts(tn, tq, r.raster))
    c = sup.metrics.counters
    assert c["quarantined_lanes"] == 1 and c["recoveries_cold"] == 1
    assert sup.engine is not first and first._pools is None
    assert sup.engine.data_parallel == 4
    sup.close()


def test_sharded_sweep_and_take_route_by_slot():
    """Carry snapshots, puts and the validity sweep address slot s in pool
    s // (max_batch / n_shards): a poisoned lane of shard 2 is found at its
    global slot, and a carry put at slot 6 comes back from slot 6."""
    jn, tn = _nets(T=8)
    (_, _), (_, tq) = _params(jn, tn)
    eng = SNNServeEngine(tn, tq, max_batch=8, data_parallel=cpu_mesh(4), device="cpu",
                         faults=FaultInjector().arm("carry", at=0, lane=5, bit=26))
    for r in _requests(8, tn.n_in, seed=6):
        r.raster = np.concatenate([r.raster, r.raster, r.raster])  # long enough to stay resident
        eng.submit(r)
    eng.poll()
    assert eng.sweep_carries() == [5]
    assert eng._pools[2][0].u[1].abs().max() >= 1 << 26
    snap = eng._take(5)
    eng._put(6, snap)
    for a, b in zip(eng._take(6), snap):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    both = eng._take_many([6, 1, 5])
    for got, slot in zip(both, [6, 1, 5]):
        for a, b in zip(got, eng._take(slot)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert eng.quarantine_lane(5).uid == 5  # admitted in slot order
    assert 5 in eng.quarantined and eng.capacity == 7
