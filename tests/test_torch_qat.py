"""The port's QAT and the Flex-plorer's refine phase against JAX's.

The contract of ``repro.snn.qat`` holds in the port bit for bit: the fake
quantization equals ``quantize_params``, and the QAT forward equals the
port's own ``run_int`` of the quantized network and JAX's ``run_qat``,
exactly, for every neuron model x topology x reset mode (the matrix of
``tests/test_qat.py``).  Training is held to JAX by tolerance (float32 sums
run in another order): gradients within 1e-4 of each leaf's max |grad|,
trained parameters within 1e-3 of each leaf's max |w|.  ``refine_candidates``
runs every candidate on one stacked candidate axis; its step equals K serial
steps within 1e-5, and its scores are exact.  Inputs come from JAX's
``init_float_params`` (carried over through numpy) and the shared seeded
datasets; JAX runs on the CPU as its own tests run it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.core.flexplorer import cost as jcost
from repro.core.flexplorer import explorer as jexp
from repro.core.flexplorer import strategies as JS
from repro.data import snn_datasets as jds
from repro.snn import qat as jqat
from repro.snn import surrogate as jsur
from repro.snn import train as jtrain
from repro_torch.core import network as tnet
from repro_torch.core import shard
from repro_torch.core import snn_layer as tsl
from repro_torch.core.flexplorer import cost as tcost
from repro_torch.core.flexplorer import explorer as texp
from repro_torch.core.flexplorer import strategies as TS
from repro_torch.data import snn_datasets as tds
from repro_torch.snn import qat as tqat
from repro_torch.snn import surrogate as tsur
from repro_torch.snn import train as ttrain
from repro_torch.train import optimizer as topt

JFN, TFN = jsur.fast_sigmoid(25.0), tsur.fast_sigmoid(25.0)


def _nets(neuron, topo, reset, w_bits=3, leak_bits=4):
    """tests/test_qat.py's ``_net`` in both packages."""
    def mk(sl, nw):
        thr = 2.5 if neuron == "synaptic" else 1.0
        layer = lambda n_in, n_out, wb: sl.LayerConfig(
            n_in=n_in, n_out=n_out, neuron=sl.NeuronModel(neuron), topology=sl.Topology(topo),
            reset=sl.ResetMode(reset), w_bits=wb, leak_bits=leak_bits, u_bits=12, threshold=thr,
        )
        return nw.NetworkConfig(layers=(layer(24, 16, w_bits), layer(16, 5, w_bits + 1)),
                                n_steps=10, name="qat-test")
    return mk(jsl, jnet), mk(tsl, tnet)


def _carry(tn, jp):
    return tnet.float_params_from_numpy(tn, [tuple(np.asarray(a) for a in p) for p in jp], "cpu")


def _flat(params):
    return [t for p in params for t in p]


def _spikes(seed, T=10, batch=6, n_in=24, density=0.3):
    return (np.random.default_rng(seed).random((T, batch, n_in)) < density).astype(np.uint8)


def _close(got_params, want_params, tol):
    """Every leaf within ``tol`` of its max |w|."""
    for a, b in zip(_flat(got_params), _flat(want_params)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        if b.size:
            assert np.abs(a.detach().numpy() - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("topo", ["ff", "ata_f", "ata_t"])
def test_fake_quant_equals_quantize_params_rounding(topo):
    jn, tn = _nets("lif", topo, "subtract")
    jp = jnet.init_float_params(jax.random.PRNGKey(0), jn)
    tp = _carry(tn, jp)
    qparams, scales = tnet.quantize_params(tn, tp)
    for jc, tc, p, q, s, jpl in zip(jn.layers, tn.layers, tp, qparams, scales, jp):
        fq = tqat.fake_quant_layer(tc, p)
        jfq = jqat.fake_quant_layer(jc, jpl)
        assert float(fq.scale) == s == float(jfq.scale)
        assert torch.equal(fq.w_ff, q.w_ff.to(torch.float32))
        assert torch.equal(fq.theta_q, q.theta_q.to(torch.float32))
        np.testing.assert_array_equal(fq.w_ff.detach().numpy(), np.asarray(jfq.w_ff))
        if topo != "ff":
            assert torch.equal(fq.w_rec, q.w_rec.to(torch.float32))
            np.testing.assert_array_equal(fq.w_rec.detach().numpy(), np.asarray(jfq.w_rec))


def _qat_against_run_int(jn, tn, key, seed):
    jp = jnet.init_float_params(jax.random.PRNGKey(key), jn)
    tp = _carry(tn, jp)
    x = _spikes(seed)
    qparams, _ = tnet.quantize_params(tn, tp)
    want = tnet.run_int(tn, qparams, torch.from_numpy(x))
    got = tqat.run_qat(tn, tp, torch.from_numpy(x), TFN)
    jgot = jqat.run_qat(jn, jp, jnp.asarray(x), JFN)
    assert got.spike_counts.dtype == torch.float32
    assert torch.equal(got.spike_counts, torch.round(got.spike_counts)), "logits must be integers"
    assert torch.equal(got.spike_counts.to(torch.int32), want.spike_counts)
    np.testing.assert_array_equal(got.spike_counts.numpy(), np.asarray(jgot.spike_counts))
    for a, b, c in zip(got.layer_spikes, want.layer_spikes, jgot.layer_spikes):
        assert torch.equal(a.to(torch.int32), b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert torch.equal(got.input_events, want.input_events)
    return want


@pytest.mark.parametrize("neuron", ["if", "lif", "synaptic"])
@pytest.mark.parametrize("topo", ["ff", "ata_f", "ata_t"])
@pytest.mark.parametrize("reset", ["zero", "subtract"])
def test_qat_forward_bit_exact_with_run_int_and_jax(neuron, topo, reset):
    """QAT logits and per-layer spike totals == quantize_params -> run_int
    == JAX's run_qat, exactly, for every config."""
    jn, tn = _nets(neuron, topo, reset)
    _qat_against_run_int(jn, tn, key=1, seed=2)


def test_qat_forward_bit_exact_at_aggressive_bits():
    jn, tn = _nets("lif", "ff", "subtract", w_bits=2, leak_bits=2)
    rec = _qat_against_run_int(jn, tn, key=3, seed=4)
    assert int(rec.layer_spikes[0].sum()) > 0


def test_qat_gradients_match_jax_and_reach_every_parameter():
    """One loss's gradients within 1e-4 of each leaf's max |grad|."""
    jn, tn = _nets("lif", "ata_t", "subtract")
    jp = jnet.init_float_params(jax.random.PRNGKey(5), jn)
    x = _spikes(6)
    y = np.random.default_rng(7).integers(0, 5, 6)

    def jloss(params):
        counts = jqat.run_qat(jn, params, jnp.asarray(x), JFN).spike_counts
        logp = jax.nn.log_softmax(counts)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1))

    jg = _flat(jax.grad(jloss)(jp))
    leaves = [t.clone().requires_grad_() for t in _flat(_carry(tn, jp))]
    params = [tsl.FloatLayerParams(*leaves[i:i + 3]) for i in range(0, len(leaves), 3)]
    counts = tqat.run_qat(tn, params, torch.from_numpy(x), TFN).spike_counts
    loss = ttrain.spike_count_loss(counts, torch.from_numpy(y))
    tg = torch.autograd.grad(loss, leaves, allow_unused=True)
    for name, i in [("w_ff.0", 0), ("w_rec.0", 1), ("theta.0", 2), ("w_ff.1", 3)]:
        a, b = tg[i].numpy(), np.asarray(jg[i])
        assert np.isfinite(a).all() and np.abs(a).sum() > 0, f"no gradient reached {name}"
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name


GRID = [(2, 3, 3), (3, 6, 8), (5, 2, 1)]  # (w_bits, w_rec_bits, leak_bits) per candidate


@pytest.mark.parametrize("neuron,topo", [("synaptic", "ata_f"), ("lif", "ata_t"), ("if", "ff")])
def test_run_qat_candidate_axis_equals_each_candidate(neuron, topo):
    """Stacked parameters with per-candidate grids: every candidate's counts
    and spike totals equal its own single-candidate run_qat exactly, and its
    layer scales equal JAX's vmapped ``layer_scale`` with traced maxima."""
    jn, tn = _nets(neuron, topo, "subtract")
    jp = jnet.init_float_params(jax.random.PRNGKey(8), jn)
    tp = _carry(tn, jp)
    cands = [tn.replace_precisions(w_bits=w, w_rec_bits=r, leak_bits=k) for w, r, k in GRID]
    wm, rm, br, ar = tqat.candidate_grid(cands, "cpu")
    K = len(cands)
    stacked = [tsl.FloatLayerParams(*(torch.stack([t] * K) for t in p)) for p in tp]
    x = torch.from_numpy(_spikes(9))
    rec = tqat.run_qat(tn, stacked, x, TFN, w_maxes=wm, rec_maxes=rm, beta_regs=br, alpha_regs=ar)
    assert rec.spike_counts.shape == (K, 6, 5) and rec.layer_spikes[0].shape == (K, 10, 6)
    for k, c in enumerate(cands):
        one = tqat.run_qat(c, tp, x, TFN)
        assert torch.equal(rec.spike_counts[k], one.spike_counts)
        assert all(torch.equal(a[k], b) for a, b in zip(rec.layer_spikes, one.layer_spikes))
    for i, (jc, tc) in enumerate(zip(jn.layers, tn.layers)):
        jstack = jax.tree.map(lambda t: jnp.stack([t] * K), jp[i])
        want = jax.vmap(lambda p, w, r: jnet.layer_scale(jc, p, w, r))(
            jstack, jnp.asarray(wm[:, i].numpy()), jnp.asarray(rm[:, i].numpy()))
        got = tnet.layer_scale(tc, stacked[i], wm[:, i], rm[:, i])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        single = tnet.layer_scale(tc, tp[i], wm[0, i], rm[0, i])
        assert single.shape == () and float(single) == float(got[0])


@pytest.fixture(scope="module")
def tiny_trained():
    """tests/test_qat.py's ``tiny_trained``: JAX trains the 256-32-10 net 2
    epochs at batch 64; the port receives its parameters."""
    def mk(sl, nw):
        return nw.NetworkConfig(
            layers=(sl.LayerConfig(n_in=256, n_out=32, w_bits=6, u_bits=16),
                    sl.LayerConfig(n_in=32, n_out=10, w_bits=6, u_bits=16)),
            n_steps=10, name="qat-tiny",
        )
    jn, tn = mk(jsl, jnet), mk(tsl, tnet)
    jtr, jte = jds.mnist_like(n=256, T=10, seed=11).split()
    ttr, tte = tds.mnist_like(n=256, T=10, seed=11).split()
    jres = jtrain.train_snn(jn, jtr, epochs=2, batch_size=64)
    return (jn, jres, jtr, jte), (tn, _carry(tn, jres.params), ttr, tte)


def test_train_snn_qat_roundtrips_through_eval_int(tiny_trained):
    """``eval_qat == eval_int(quantize_params(qat_net))`` exactly; the QAT
    epoch's loss within 1e-3 relative of JAX's, parameters within 1e-3."""
    (jn, jres, jtr, jte), (tn, tp, ttr, tte) = tiny_trained
    kw = dict(epochs=1, batch_size=64, lr=5e-4)
    jq = jtrain.train_snn(jn, jtr, qat=jqat.PrecisionConfig(w_bits=3), init_params=jres.params, **kw)
    tq = ttrain.train_snn(tn, ttr, qat=tqat.PrecisionConfig(w_bits=3), init_params=tp,
                          device="cpu", **kw)
    assert tq.qat_net is not None and all(lc.w_bits == 3 for lc in tq.qat_net.layers)
    qparams, _ = tnet.quantize_params(tq.qat_net, tq.params)
    acc_int = ttrain.eval_int(tq.qat_net, qparams, tte)
    assert tqat.eval_qat(tq.qat_net, tq.params, tte) == acc_int  # the parity contract
    assert abs(tq.history[0]["loss"] - jq.history[0]["loss"]) <= 1e-3 * jq.history[0]["loss"]
    _close(tq.params, jq.params, 1e-3)


def _candidates(net):
    return [
        net.replace_precisions(w_bits=2, leak_bits=3),
        net.replace_precisions(w_bits=3, leak_bits=3),
        net.replace_precisions(w_bits=4, leak_bits=8),
    ]


def test_refine_candidates_matches_jax(tiny_trained):
    """tests/test_qat.py's three candidates: the PTQ scores and history[0]
    equal JAX's exactly, best >= base, every best checkpoint scores its
    claimed accuracy through eval_int, and the refined parameters are within
    1e-3 of each leaf's max |w| of JAX's."""
    (jn, jres, jtr, jte), (tn, tp, ttr, tte) = tiny_trained
    kw = dict(epochs=1, batch_size=64, eval_batch=128)
    jr = jqat.refine_candidates(jn, _candidates(jn), jres.params, jtr, jte, **kw)
    tr = tqat.refine_candidates(tn, _candidates(tn), tp, ttr, tte, **kw)
    np.testing.assert_array_equal(tr.base_acc, jr.base_acc)
    assert tr.history[0] == jr.history[0]
    assert [h["epoch"] for h in tr.history] == [-1, 0]
    assert (tr.best_acc >= tr.base_acc).all()
    for k, cand in enumerate(_candidates(tn)):
        ptq, _ = tnet.quantize_params(cand, tp)
        assert tr.base_acc[k] == ttrain.eval_int(cand, ptq, tte, batch_size=128)
        qp, _ = tnet.quantize_params(cand, tr.params[k])
        assert ttrain.eval_int(cand, qp, tte, batch_size=128) == tr.best_acc[k]
        _close(tr.params[k], jr.params[k], 1e-3)
    # a mesh is taken now (tests/test_torch_shard.py runs it): an over-ask
    # is refused before any training, as JAX's make_mesh refuses it
    with pytest.raises(ValueError, match="exceeds"):
        tqat.refine_candidates(tn, _candidates(tn), tp, ttr, tte, mesh=shard.make_mesh().n_shards + 1)


def test_refine_step_equals_serial_steps(tiny_trained):
    """One candidate-axis step (per-candidate clip, one AdamW on the stacks)
    against K train_snn-style steps, one per candidate at its own precision:
    loss, accuracy and every updated parameter within 1e-5."""
    from repro_torch.snn.train import _float_batch, _layers, _leaves, _train_step

    _, (tn, tp, ttr, _) = tiny_trained
    cands = _candidates(tn)
    K = len(cands)
    spikes, labels = next(ttr.batches(64, np.random.default_rng(0)))
    x, y = _float_batch(spikes, labels, "cpu")
    grid = tqat.candidate_grid(cands, "cpu")
    opt = topt.adamw(topt.linear_warmup_cosine(5e-4, 4, 4))
    stacked = [torch.stack([t] * K) for t in _leaves(tp)]
    new, _, loss, acc = tqat.refine_step(tn, opt, stacked, opt.init(stacked), grid, x, y, TFN,
                                         1e-4)
    assert loss.shape == acc.shape == (K,)
    for k, cand in enumerate(cands):
        def loss_fn(params, cand=cand):
            rec = tqat.run_qat(cand, params, x, TFN)
            total = sum(s.sum() for s in rec.layer_spikes) / x.shape[1]
            value = ttrain.spike_count_loss(rec.spike_counts, y, 1e-4, total)
            return value, (rec.predictions() == y).float().mean()

        leaves = _leaves(tp)
        one, _, l1, a1 = _train_step(loss_fn, opt, leaves, opt.init(leaves))
        assert abs(float(loss[k]) - float(l1)) <= 1e-5 * abs(float(l1))
        assert float(acc[k]) == float(a1)
        for a, b in zip(new, one):
            if b.numel():
                assert (a[k] - b).abs().max() <= 1e-5 * b.abs().max()
        assert any(not torch.equal(a[k], b) for a, b in zip(_leaves(tp), one)), "no update"
    assert _layers(new)[0].w_ff.shape == (K, 256, 32)


def _explore_setup():
    """The tiny net of tests/test_torch_flexplorer.py (32-16-4, T = 6) with a
    training split for the refine phase."""
    def mk(sl, nw):
        return nw.NetworkConfig(
            layers=(
                sl.LayerConfig(n_in=32, n_out=16, neuron=sl.NeuronModel.LIF, beta=0.9),
                sl.LayerConfig(n_in=16, n_out=4, neuron=sl.NeuronModel.LIF, beta=0.77),
            ),
            n_steps=6,
        )
    jn, tn = mk(jsl, jnet), mk(tsl, tnet)
    jp = jnet.init_float_params(jax.random.PRNGKey(1), jn)

    def data(seed):
        ds = jds.mnist_like(n=64, T=6, seed=seed)
        return tds.SpikeDataset(ds.spikes[:, :, :32], ds.labels % 4, ds.n_classes, ds.name)

    ev, tr = data(6), data(7)
    return (jn, jp, ev, tr), (tn, _carry(tn, jp), ev, tr)


WEIGHTS = dict(c_hw=0.4, c_acc=0.4, c_perf=0.2, c_lat=0.4, c_energy=0.4, c_bw=0.2)


def test_explore_snn_refine_matches_jax():
    """NSGA-II with ``RefineSpec(top_k=2)`` and the perf terms on: the
    explored part of ``to_json()`` equals JAX's exactly; each refined entry
    has JAX's PTQ ``base_accuracy``, an accuracy >= it that its own
    parameters score through ``eval_int`` (the re-measured traffic), and
    parameters within 1e-3 of JAX's."""
    (jn, jp, ev, tr), (tn, tp, _, _) = _explore_setup()
    space = dict(ff_bits=(2, 4, 6, 8, 12), leak_bits=(1, 3, 8))

    def run(E, S, C, net, params):
        return E.explore_snn(
            net, params, ev,
            search=E.SearchSpec(space=E.SNNSearchSpace(**space), strategy="nsga2",
                                config=S.NSGAConfig(population=8, generations=2, seed=0),
                                weights=C.CostWeights(**WEIGHTS)),
            evaluate=E.EvalSpec(batch=32),
            refine=E.RefineSpec(top_k=2, train_ds=tr, epochs=1, batch=32),
        )

    jr, trr = run(jexp, JS, jcost, jn, jp), run(texp, TS, tcost, tn, tp)
    explored = lambda r: {k: v for k, v in r.to_json().items() if not k.startswith("refined")}
    assert json.dumps(explored(trr), sort_keys=True) == json.dumps(explored(jr), sort_keys=True)
    assert len(trr.refined) == len(jr.refined) == 2
    assert [r.cfg for r in trr.refined] == [r.cfg for r in jr.refined]
    for got, want in zip(trr.refined, jr.refined):
        assert got.base_accuracy == want.base_accuracy == trr.search.cache[got.cfg].accuracy
        assert got.accuracy >= got.base_accuracy
        assert got.hw_cost == want.hw_cost
        qp, _ = tnet.quantize_params(got.net, got.params)
        assert all(torch.equal(a, b) for p, q in zip(qp, got.qparams) for a, b in zip(p, q))
        assert ttrain.eval_int(got.net, qp, ev, batch_size=32) == got.accuracy
        _close(got.params, want.params, 1e-3)
    out = trr.to_json()
    assert len(out["refined"]) == 2 and out["refined_front"]
    assert all(r["refined"] and "total_cost" in r for r in out["refined"])
    assert "refined" in trr.report()


def test_explore_snn_refine_requires_train_ds():
    _, (tn, tp, ev, _) = _explore_setup()
    with pytest.raises(ValueError, match="refine_train_ds"):
        texp.explore_snn(tn, tp, ev, refine=texp.RefineSpec(top_k=1))
