"""The port's float training path against JAX's.

``run_float`` (spike counts, loss and gradients), the surrogates' backward,
the optimizer (AdamW / SGD updates, global-norm clipping per candidate, the
schedules), ``train_snn`` and ``eval_float`` of ``repro_torch`` on the CPU
against ``repro``, on the same inputs: float parameters from JAX's
``init_float_params`` carried over through numpy, rasters from seeded numpy
and ``mnist_like``.  Tolerances, each stated where it is used: spike counts
exact, a loss within 1e-5 relative, gradients within 1e-4 of each leaf's
max |grad|, surrogate gradients within 1 float32 ulp, one optimizer update
within 1e-6 relative, schedules within 1e-7, and two epochs of training
within 1e-3 (float32 sums run in another order in each package, and
training compounds them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.data import snn_datasets as jds
from repro.snn import surrogate as jsur
from repro.snn import train as jtrain
from repro.train import optimizer as jopt
from repro_torch.core import network as tnet
from repro_torch.core import shard
from repro_torch.core import snn_layer as tsl
from repro_torch.data import snn_datasets as tds
from repro_torch.snn import surrogate as tsur
from repro_torch.snn import train as ttrain
from repro_torch.train import optimizer as topt

# (neuron, topology, reset): every neuron model, topology and reset mode
CASES = [
    ("lif", "ff", "subtract"),
    ("if", "ff", "zero"),
    ("lif", "ata_f", "zero"),
    ("if", "ata_f", "subtract"),
    ("lif", "ata_t", "subtract"),
    ("if", "ata_t", "zero"),
    ("synaptic", "ff", "zero"),
    ("synaptic", "ata_f", "subtract"),
    ("synaptic", "ata_t", "subtract"),
]


def _nets(neuron, topology, reset, T=10):
    def mk(sl, nw):
        thr = 1.2 if neuron == "synaptic" else 0.5
        layer = lambda n_in, n_out: sl.LayerConfig(
            n_in=n_in, n_out=n_out, neuron=sl.NeuronModel(neuron), topology=sl.Topology(topology),
            reset=sl.ResetMode(reset), beta=0.9, alpha=0.8, threshold=thr,
        )
        return nw.NetworkConfig(layers=(layer(24, 16), layer(16, 5)), n_steps=T, name="train-test")
    return mk(jsl, jnet), mk(tsl, tnet)


def _carry(tn, jp):
    return tnet.float_params_from_numpy(tn, [tuple(np.asarray(a) for a in p) for p in jp], "cpu")


def _flat(params):
    return [t for p in params for t in p]


def _tiny():
    def mk(sl, nw):
        return nw.NetworkConfig(
            layers=(sl.LayerConfig(n_in=256, n_out=32, w_bits=6, u_bits=16),
                    sl.LayerConfig(n_in=32, n_out=10, w_bits=6, u_bits=16)),
            n_steps=10, name="train-tiny",
        )
    return mk(jsl, jnet), mk(tsl, tnet)


@pytest.fixture(scope="module")
def trained():
    """tests/test_qat.py's tiny setup trained 2 epochs at batch 64 in both
    packages from JAX's initial parameters."""
    jn, tn = _tiny()
    jp = jnet.init_float_params(jax.random.PRNGKey(0), jn)
    jtr, jte = jds.mnist_like(n=256, T=10, seed=11).split()
    ttr, tte = tds.mnist_like(n=256, T=10, seed=11).split()
    jres = jtrain.train_snn(jn, jtr, epochs=2, batch_size=64, init_params=jp)
    tres = ttrain.train_snn(tn, ttr, epochs=2, batch_size=64, init_params=_carry(tn, jp),
                            device="cpu")
    return (jn, jres, jte), (tn, tres, tte)


def _loss_and_grads_jax(jn, jp, x, y, spike_fn):
    def loss(p):
        rec = jnet.run_float(jn, p, jnp.asarray(x), spike_fn)
        total = sum(jnp.sum(s) for s in rec.layer_spikes) / x.shape[1]
        return jtrain.spike_count_loss(rec.spike_counts, jnp.asarray(y), 1e-4, total), rec.spike_counts
    (value, counts), grads = jax.value_and_grad(loss, has_aux=True)(jp)
    return float(value), np.asarray(counts), [np.asarray(g) for g in _flat(grads)]


def _loss_and_grads_port(tn, tp, x, y, spike_fn, backend="reference"):
    leaves = [t.clone().requires_grad_() for t in _flat(tp)]
    params = [tsl.FloatLayerParams(*leaves[i:i + 3]) for i in range(0, len(leaves), 3)]
    rec = tnet.run_float(tn, params, torch.from_numpy(x), spike_fn, backend=backend)
    total = sum(s.sum() for s in rec.layer_spikes) / x.shape[1]
    loss = ttrain.spike_count_loss(rec.spike_counts, torch.from_numpy(y), 1e-4, total)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [np.zeros(t.shape, np.float32) if g is None else g.numpy() for g, t in zip(grads, leaves)]
    return float(loss), rec.spike_counts.detach().numpy(), grads


@pytest.mark.parametrize("neuron,topology,reset", CASES, ids=["-".join(c) for c in CASES])
def test_run_float_loss_and_gradients_match_jax(neuron, topology, reset):
    """Spike counts exact; the loss within 1e-5 relative; every gradient leaf
    within 1e-4 of its max |grad| (float32 sums in another order)."""
    jn, tn = _nets(neuron, topology, reset)
    jp = jnet.init_float_params(jax.random.PRNGKey(1), jn)
    rng = np.random.default_rng(2)
    x = (rng.random((10, 6, 24)) < 0.4).astype(np.float32)
    y = rng.integers(0, 5, 6)
    jv, jc, jg = _loss_and_grads_jax(jn, jp, x, y, jsur.fast_sigmoid(25.0))
    tv, tc, tg = _loss_and_grads_port(tn, _carry(tn, jp), x, y, tsur.fast_sigmoid(25.0))
    np.testing.assert_array_equal(tc, jc)
    assert jc.sum() > 0, "the output layer never spiked"
    assert abs(tv - jv) <= 1e-5 * abs(jv)
    for a, b in zip(tg, jg):
        assert a.shape == b.shape
        if b.size:
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    assert any(np.abs(b).max() > 0 for b in jg if b.size)


def test_fused_and_event_run_float_delegate_to_reference():
    jn, tn = _nets("lif", "ff", "subtract")
    tp = _carry(tn, jnet.init_float_params(jax.random.PRNGKey(1), jn))
    x = (np.random.default_rng(3).random((10, 4, 24)) < 0.4).astype(np.float32)
    fn = tsur.fast_sigmoid(25.0)
    want = tnet.run_float(tn, tp, torch.from_numpy(x), fn)
    for backend in ("fused", "event"):
        got = tnet.run_float(tn, tp, torch.from_numpy(x), fn, backend=backend)
        assert torch.equal(got.spike_counts, want.spike_counts)
        assert all(torch.equal(a, b) for a, b in zip(got.layer_spikes, want.layer_spikes))


@pytest.mark.parametrize("kind", ["fast_sigmoid", "atan"])
def test_surrogate_forward_and_backward_match_jax(kind):
    """Heaviside forward exactly; the backward within 1 float32 ulp."""
    x = np.concatenate([np.random.default_rng(4).normal(0, 0.3, 999), [0.0, -0.0, 1e-30]])
    x = x.astype(np.float32)
    g = np.random.default_rng(5).normal(0, 1, x.shape).astype(np.float32)
    jfn = jsur.fast_sigmoid(25.0) if kind == "fast_sigmoid" else jsur.atan_surrogate(2.0)
    tfn = tsur.fast_sigmoid(25.0) if kind == "fast_sigmoid" else tsur.atan_surrogate(2.0)
    jy, vjp = jax.vjp(jfn, jnp.asarray(x))
    (jgx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    ty = tfn(xt)
    (tgx,) = torch.autograd.grad(ty, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    assert ty.dtype == torch.float32
    np.testing.assert_array_max_ulp(tgx.numpy(), np.asarray(jgx), maxulp=1)


def _params_and_grads(seed, shapes):
    rng = np.random.default_rng(seed)
    params = [rng.normal(0, 0.2, s).astype(np.float32) for s in shapes]
    grads = [rng.normal(0, 0.05, s).astype(np.float32) for s in shapes]
    return params, grads


SHAPES = [(16, 8), (), (8, 4), (0,)]


@pytest.mark.parametrize("which", ["adamw", "sgd", "sgd-nesterov"])
def test_optimizer_updates_match_jax(which):
    """Three updates from given gradients (the warm-up schedule's first
    steps), each within 1e-6 relative of JAX's."""
    params, grads = _params_and_grads(6, SHAPES)
    sched = (jopt.linear_warmup_cosine(2e-3, 2, 10), topt.linear_warmup_cosine(2e-3, 2, 10))
    if which == "adamw":
        jo, to = jopt.adamw(sched[0]), topt.adamw(sched[1])
    else:
        nest = which == "sgd-nesterov"
        jo, to = jopt.sgd(sched[0], nesterov=nest), topt.sgd(sched[1], nesterov=nest)
    jp, tp = [jnp.asarray(p) for p in params], [torch.from_numpy(p) for p in params]
    js, ts = jo.init(jp), to.init(tp)
    for k in range(3):
        g = [np.asarray(a * (1 + k), np.float32) for a in grads]
        ju, js = jo.update([jnp.asarray(a) for a in g], js, jp)
        tu, ts = to.update([torch.from_numpy(a) for a in g], ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    assert int(ts.step) == 3 and ts.step.dtype == torch.int32


@pytest.mark.parametrize(
    "name,args",
    [("cosine", (2e-3, 7)), ("warmup", (2e-3, 4, 20)), ("warmup", (5e-4, 1, 1)),
     ("constant", (3e-3,))],
)
def test_schedules_match_jax(name, args):
    """Every step from 0 to past the horizon, the warm-up edge included,
    within 1e-7 (float32 cos in both packages)."""
    make = {"cosine": "cosine_schedule", "warmup": "linear_warmup_cosine",
            "constant": "constant_schedule"}[name]
    jf, tf = getattr(jopt, make)(*args), getattr(topt, make)(*args)
    for step in range(0, 25):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax_per_candidate(max_norm):
    """``batch_dims=0`` against JAX's function; ``batch_dims=1`` against JAX's
    function vmapped over the candidate axis (each candidate its own norm)."""
    _, grads = _params_and_grads(7, [(3,) + s for s in SHAPES])
    grads[0][1] *= 100.0  # one candidate far above the norm
    jg = [jnp.asarray(g) for g in grads]
    tg = [torch.from_numpy(g) for g in grads]
    want, wnorm = jax.vmap(lambda gs: jopt.clip_by_global_norm(gs, max_norm))(jg)
    got, gnorm = topt.clip_by_global_norm(tg, max_norm, batch_dims=1)
    np.testing.assert_allclose(gnorm.numpy(), np.asarray(wnorm), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    want1, wnorm1 = jopt.clip_by_global_norm([g[0] for g in jg], max_norm)
    got1, gnorm1 = topt.clip_by_global_norm([g[0] for g in tg], max_norm)
    np.testing.assert_allclose(float(gnorm1), float(wnorm1), rtol=1e-6)
    for a, b in zip(got1, want1):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="batch_dims"):
        topt.clip_by_global_norm(tg, 1.0, batch_dims=2)


def test_train_snn_matches_jax(trained):
    """Two epochs at batch 64 from the same parameters and batch order: the
    loss history within 1e-3 relative and every parameter within 1e-3 of its
    max |w|.  Measured on the CPU: loss 4e-7 relative, parameters 7e-6."""
    (jn, jres, _), (tn, tres, _) = trained
    assert [h["epoch"] for h in tres.history] == [0, 1]
    for a, b in zip(tres.history, jres.history):
        assert set(a) == set(b)
        assert abs(a["loss"] - b["loss"]) <= 1e-3 * abs(b["loss"])
        assert abs(a["train_acc"] - b["train_acc"]) <= 1e-3
    for a, b in zip(_flat(tres.params), _flat(jres.params)):
        b = np.asarray(b)
        assert not a.requires_grad and a.device.type == "cpu"
        if b.size:
            assert np.abs(a.numpy() - b).max() <= 1e-3 * np.abs(b).max()
    assert tres.net is tn and tres.qat_net is None


def test_eval_float_matches_jax(trained):
    (jn, jres, jte), (tn, tres, tte) = trained
    tp = _carry(tn, jres.params)
    want = jtrain.eval_float(jn, jres.params, jte, batch_size=16)
    assert ttrain.eval_float(tn, tp, tte, batch_size=16) == want
    # a mesh is taken now: an over-ask is refused as JAX's make_mesh refuses
    # it, and 3 shards on the CPU give the serial accuracy
    with pytest.raises(ValueError, match="exceeds"):
        ttrain.eval_float(tn, tp, tte, mesh=shard.make_mesh().n_shards + 1)
    mesh = shard.make_mesh(3, devices=["cpu"] * 3)
    assert ttrain.eval_float(tn, tp, tte, batch_size=16, mesh=mesh) == want


def test_train_snn_device_rules():
    """The card by default (refused here, with no card); ``init_params`` must
    already be on ``device``; without them a torch generator seeded with
    ``seed`` draws the parameters."""
    _, tn = _tiny()
    ds = tds.mnist_like(n=64, T=10, seed=11)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train_snn(tn, ds, epochs=1)
    elsewhere = [tsl.FloatLayerParams(*(torch.empty(t.shape, device="meta") for t in p))
                 for p in tnet.init_float_params(torch.Generator(), tn, device="cpu")]
    with pytest.raises(ValueError, match="init_params are on meta"):
        ttrain.train_snn(tn, ds, epochs=1, init_params=elsewhere, device="cpu")
    res = ttrain.train_snn(tn, ds, epochs=0, seed=3, device="cpu")
    want = tnet.init_float_params(torch.Generator().manual_seed(3), tn, device="cpu")
    assert res.history == []
    assert all(torch.equal(a, b) for a, b in zip(_flat(res.params), _flat(want)))


def test_train_snn_logs_eval_accuracy(trained, capsys):
    _, (tn, tres, tte) = trained
    tds_small = tds.SpikeDataset(tte.spikes[:8], tte.labels[:8], tte.n_classes, "small")
    res = ttrain.train_snn(tn, tds_small, epochs=1, batch_size=8, init_params=tres.params,
                           eval_ds=tds_small, log_every=1, device="cpu")
    assert res.history[0]["eval_acc"] == ttrain.eval_float(tn, res.params, tds_small)
    assert "[train_snn:train-tiny]" in capsys.readouterr().out
