"""The port's population sweep against JAX's, exactly.

``run_int_population`` (int32 counts and emitted totals) and
``eval_int_population`` (float64 accuracies, float32 stats) of
``repro_torch`` on the CPU against ``repro``'s vmapped sweep, on the same
inputs: float weights from ``jax.random`` (``init_float_params``), quantized
by JAX and carried over through numpy and ``int_params_from_numpy``; rasters
from ``jax.random`` and ``mnist_like``.  Populations span ``w_bits`` 2-16 and
``leak_bits`` 1/3/8 over every neuron model, topology and reset mode.  Sizes
stay small (widths <= 24, T <= 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbe
from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.data import snn_datasets as jds
from repro.snn import train as jtrain
from repro_torch.core import backend as tbe
from repro_torch.core import network as tnet
from repro_torch.core import shard
from repro_torch.core import snn_layer as tsl
from repro_torch.data import snn_datasets as tds
from repro_torch.kernels import work
from repro_torch.kernels.lif_scan.lif_scan import ataf_scan, lif_scan
from repro_torch.kernels.lif_scan.ref import lif_scan_ref
from repro_torch.snn import train as ttrain

# (w_bits, w_rec_bits, leak_bits) of each candidate
CANDIDATES = [(2, 3, 1), (4, 16, 3), (8, 6, 8), (16, 2, 3), (12, 8, 1)]

# (neuron, topology, reset): every neuron model, topology and reset mode;
# both layers take the neuron model (IF: the bypass register everywhere)
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


def _nets(neuron, topology, reset, n_in=24, hidden=12, n_out=4, T=5):
    def mk(sl, nw):
        l0 = sl.LayerConfig(n_in=n_in, n_out=hidden, neuron=sl.NeuronModel(neuron),
                            topology=sl.Topology(topology), reset=sl.ResetMode(reset),
                            beta=0.9, alpha=0.8, threshold=0.6)
        l1 = sl.LayerConfig(n_in=hidden, n_out=n_out, neuron=sl.NeuronModel(neuron),
                            reset=sl.ResetMode(reset), beta=0.77, threshold=0.6)
        return nw.NetworkConfig(layers=(l0, l1), n_steps=T, name=f"{neuron}-{topology}-{reset}")
    return mk(jsl, jnet), mk(tsl, tnet)


def _population(jn, tn, seed=1, candidates=CANDIDATES):
    """Per-candidate nets and quantized parameters in both packages: JAX
    quantizes, the port receives the int32 arrays through numpy."""
    jp = jnet.init_float_params(jax.random.PRNGKey(seed), jn)
    jnets, tnets, jqs, tqs = [], [], [], []
    for w, r, leak in candidates:
        jc = jn.replace_precisions(w_bits=w, w_rec_bits=r, leak_bits=leak)
        tc = tn.replace_precisions(w_bits=w, w_rec_bits=r, leak_bits=leak)
        jq, _ = jnet.quantize_params(jc, jp)
        arrays = [tuple(np.asarray(a) for a in p) for p in jq]
        jnets.append(jc)
        tnets.append(tc)
        jqs.append(jq)
        tqs.append(tnet.int_params_from_numpy(tc, arrays, device="cpu"))
    return (jp, jnets, jqs), (tnets, tqs)


def _raster(key, T, B, n_in, rate=0.3):
    return np.asarray(jax.random.bernoulli(jax.random.PRNGKey(key), rate, (T, B, n_in)), np.int32)


@pytest.mark.parametrize("neuron,topology,reset", CASES, ids=["-".join(c) for c in CASES])
def test_run_int_population_matches_jax(neuron, topology, reset):
    jn, tn = _nets(neuron, topology, reset)
    (_, jnets, jqs), (tnets, tqs) = _population(jn, tn)
    x = _raster(3, 5, 6, 24)
    js, jb, ja = jbe.stack_population(jnets, jqs)
    jc, je = jbe.run_int_population(jn, js, jb, ja, jnp.asarray(x), return_events=True)
    ts, tb, ta = tbe.stack_population(tnets, tqs)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    tc, te = tbe.run_int_population(tn, ts, tb, ta, torch.from_numpy(x), return_events=True)
    assert tc.dtype == te.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert int(te.sum()) > 0, "the population never spiked"
    counts_only = tbe.run_int_population(tn, ts, tb, ta, torch.from_numpy(x))
    assert torch.equal(counts_only, tc)
    sc, se = tbe._run_int_dynamic(tn, ts, tb, ta, torch.from_numpy(x))  # step-major
    assert torch.equal(sc, tc) and torch.equal(se, te)


def test_int_layer_step_dynamic_candidate_axis_matches_jax():
    """One ATA-T Synaptic step with a candidate axis ([P, 1, 1] registers)
    against JAX's per-candidate step with scalar registers."""
    jn, tn = _nets("synaptic", "ata_t", "subtract")
    (_, jnets, jqs), (tnets, tqs) = _population(jn, tn)
    ts, tb, ta = tbe.stack_population(tnets, tqs)
    P, B, N = len(CANDIDATES), 3, jn.layers[0].n_out
    rng = np.random.default_rng(0)
    u = rng.integers(-3000, 3000, (P, B, N)).astype(np.int32)
    i_syn = rng.integers(-3000, 3000, (P, B, N)).astype(np.int32)
    prev = rng.integers(0, 2, (P, B, N)).astype(np.int32)
    s_in = _raster(5, 1, B, 24)[0]
    p0 = ts[0]
    col = lambda t: t.reshape(P, 1, 1)
    params = tsl.IntLayerParams(w_ff=p0.w_ff, w_rec=p0.w_rec, theta_q=col(p0.theta_q))
    state = tsl.LayerState(*(torch.from_numpy(a) for a in (u, i_syn, prev)))
    got_state, got_spk = tsl.int_layer_step_dynamic(
        tn.layers[0], params, state, torch.from_numpy(s_in), col(tb[:, 0]), col(ta[:, 0])
    )
    for c in range(P):
        jstate = jsl.LayerState(jnp.asarray(u[c]), jnp.asarray(i_syn[c]), jnp.asarray(prev[c]))
        want_state, want_spk = jsl.int_layer_step_dynamic(
            jnets[c].layers[0], jqs[c][0], jstate, jnp.asarray(s_in),
            jnp.int32(jnets[c].layers[0].beta_code().decay_rate_register),
            jnp.int32(jnets[c].layers[0].alpha_code().decay_rate_register),
        )
        np.testing.assert_array_equal(got_spk[c].numpy(), np.asarray(want_spk))
        for g, w in zip(got_state, want_state):
            np.testing.assert_array_equal(g[c].numpy(), np.asarray(w))


def _dataset(n_in, n_classes, n=40, T=5, seed=6):
    ds = jds.mnist_like(n=n, T=T, seed=seed)
    ds.spikes = ds.spikes[:, :, :n_in]
    ds.labels = ds.labels % n_classes
    return ds, tds.SpikeDataset(ds.spikes, ds.labels, ds.n_classes, ds.name)


@pytest.mark.parametrize(
    "neuron,topology,reset,batch",
    [("lif", "ata_f", "subtract", 16), ("if", "ff", "zero", 40), ("synaptic", "ata_t", "zero", 7)],
)
def test_eval_int_population_matches_jax_bit_for_bit(neuron, topology, reset, batch):
    """Accuracies (float64) and float32 stats equal JAX's vmapped sweep bit
    for bit, including a ragged final batch (40 = 16 + 16 + 8, 7 x 5 + 5);
    each candidate's accuracy and stats also equal serial ``eval_int``."""
    jn, tn = _nets(neuron, topology, reset)
    (_, jnets, jqs), (tnets, tqs) = _population(jn, tn)
    jds_, tds_ = _dataset(24, 4)
    ja, jst = jtrain.eval_int_population(jn, jnets, jqs, jds_, batch_size=batch, return_stats=True)
    ta, tst = ttrain.eval_int_population(tn, tnets, tqs, tds_, batch_size=batch, return_stats=True)
    assert isinstance(ta, np.ndarray) and ta.dtype == np.float64
    np.testing.assert_array_equal(ta, np.asarray(ja))
    assert len(tst) == len(CANDIDATES)
    for want, got in zip(jst, tst):
        for w, g in zip(
            [want["input_events_per_step"], *want["layer_events_per_step"]],
            [got["input_events_per_step"], *got["layer_events_per_step"]],
        ):
            assert g.dtype == np.asarray(w).dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))
    accs_only = ttrain.eval_int_population(tn, tnets, tqs, tds_, batch_size=batch)
    np.testing.assert_array_equal(accs_only, ta)
    for c, (net_c, q_c) in enumerate(zip(tnets, tqs)):
        acc, st = ttrain.eval_int(net_c, q_c, tds_, batch_size=batch, return_stats=True)
        assert acc == ta[c]
        for a, b in zip(st["layer_events_per_step"], tst[c]["layer_events_per_step"]):
            np.testing.assert_array_equal(a, b)


def test_argmax_ties_pick_the_first_maximum():
    """Random low-precision weights tie spike counts often; the sweep's
    predictions take the first maximum, as ``jnp.argmax`` does."""
    jn, tn = _nets("lif", "ata_f", "subtract")
    (_, jnets, jqs), (tnets, tqs) = _population(jn, tn)
    x = _raster(9, 5, 32, 24, rate=0.15)
    js, jb, ja = jbe.stack_population(jnets, jqs)
    jc = np.asarray(jbe.run_int_population(jn, js, jb, ja, jnp.asarray(x)))
    ts, tb, ta = tbe.stack_population(tnets, tqs)
    tc = tbe.run_int_population(tn, ts, tb, ta, torch.from_numpy(x))
    top = jc.max(axis=-1, keepdims=True)
    tied = (jc == top).sum(axis=-1) > 1
    assert tied.sum() >= 10, "the case must hold ties"
    np.testing.assert_array_equal(torch.argmax(tc, dim=-1).numpy(), np.asarray(jnp.argmax(jc, axis=-1)))
    np.testing.assert_array_equal(torch.argmax(tc, dim=-1).numpy(), np.argmax(jc, axis=-1))


@pytest.mark.parametrize("zero", [False, True], ids=["subtract", "zero"])
def test_lif_scan_candidate_axis_equals_scalar_per_candidate(zero):
    """The candidate-axis scan ([P, T, B, N], theta and registers [P]) equals
    the scalar scan of each candidate, bypass (256 and a 9-bit register with
    bit 8 set) included, through the wrapper and its plain version."""
    rng = np.random.default_rng(3)
    regs = [0, 1, 128, 243, 255, 256, 256 + 77]
    P = len(regs)
    cur = torch.from_numpy(rng.integers(-700, 900, (P, 7, 3, 20)).astype(np.int32))
    theta = torch.from_numpy(rng.integers(1, 1500, P).astype(np.int32))
    k = torch.tensor(regs, dtype=torch.int32)
    n0 = lif_scan.launches
    spk, u = lif_scan(cur, theta_q=theta, decay_k=k, u_bits=12, reset_to_zero=zero)
    assert lif_scan.launches == n0  # the CPU runs the plain version
    spk_ref, u_ref = lif_scan_ref(cur, theta, k, 12, zero)
    assert torch.equal(spk, spk_ref) and torch.equal(u, u_ref)
    assert spk.shape == cur.shape and u.shape == (P, 3, 20)
    for c in range(P):
        k_c = 256 if regs[c] >= 256 else regs[c]
        s1, u1 = lif_scan_ref(cur[c], int(theta[c]), k_c, 12, zero)
        assert torch.equal(spk[c], s1) and torch.equal(u[c], u1), f"candidate {c}"


def test_lif_scan_candidate_axis_checks_its_registers():
    cur = torch.zeros(2, 3, 1, 4, dtype=torch.int32)
    good = torch.tensor([5, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"theta_q must be int32 \[2\]"):
        lif_scan(cur, theta_q=5, decay_k=good)
    with pytest.raises(ValueError, match=r"decay_k must be int32 \[2\]"):
        lif_scan(cur, theta_q=good, decay_k=good.to(torch.int64))
    with pytest.raises(ValueError, match=r"decay_k must be int32 \[2\]"):
        lif_scan(cur, theta_q=good, decay_k=good[:1])


# (neuron, reset, u_bits) of the ATA-F scan
ATAF_SCAN_CASES = [(n, r, b) for n in ("if", "lif") for r in ("subtract", "zero") for b in (8, 16)]
# self-weights: zero, negative, and the w_rec_bits = 16 extremes (twice each)
W_SELF = [0, -3, 41, -(2**15), 2**15 - 1, 2**15, -(2**15), -700]


@pytest.mark.parametrize(
    "neuron,reset,u_bits", ATAF_SCAN_CASES, ids=["-".join(map(str, c)) for c in ATAF_SCAN_CASES]
)
def test_ataf_scan_equals_the_step_loop(neuron, reset, u_bits):
    """``ataf_scan`` on the CPU equals ``_scan_currents`` with a candidate
    axis (the population's step loop) bit for bit: per-candidate theta,
    self-weight and decay register (the bypass always for IF, among others
    for LIF), currents a third each near the int32 maximum, near its
    minimum and moderate, so that I[t] + w_self and u + acc wrap."""
    rng = np.random.default_rng(u_bits + 3 * (neuron == "if") + 7 * (reset == "zero"))
    P, T, B, N = len(W_SELF), 9, 4, 13
    band = rng.integers(0, 3, (P, T, B, N))
    near_max = rng.integers(2**31 - 2**16, 2**31, (P, T, B, N))
    near_min = rng.integers(-(2**31), -(2**31) + 2**16, (P, T, B, N))
    moderate = rng.integers(-(2**u_bits), 2**u_bits, (P, T, B, N))
    cur = np.choose(band, [near_max, near_min, moderate]).astype(np.int32)
    cur[1] = moderate[1]  # one candidate on moderate currents alone
    qmax = 2 ** (u_bits - 1) - 1
    theta = rng.integers(1, qmax, P).astype(np.int32)
    regs = [256, 256 + 77, 256 + 255] if neuron == "if" else [0, 1, 128, 243, 255, 256, 256 + 5]
    k = rng.choice(regs, P).astype(np.int32)
    cur_t, w_t, theta_t, k_t = (torch.from_numpy(a) for a in (cur, np.int32(W_SELF), theta, k))
    n0 = ataf_scan.launches
    with work.Recorder("cpu") as rec:
        got = ataf_scan(cur_t, w_self=w_t, theta_q=theta_t, decay_k=k_t, u_bits=u_bits,
                        reset_to_zero=reset == "zero")
    assert ataf_scan.launches == n0  # the CPU runs the plain version
    assert [s.name for s in rec.spans] == ["ataf_scan"]
    cfg = tsl.LayerConfig(n_in=1, n_out=N, neuron=tsl.NeuronModel(neuron), u_bits=u_bits,
                          topology=tsl.Topology.ATA_F, reset=tsl.ResetMode(reset))
    col = lambda t: t.reshape(P, 1, 1)
    params = tsl.IntLayerParams(w_ff=torch.zeros(1, N, dtype=torch.int32), w_rec=col(w_t),
                                theta_q=col(theta_t))
    z = lambda: torch.zeros(P, B, N, dtype=torch.int32)
    _, want = tsl._scan_currents(cfg, params, tsl.LayerState(z(), z(), z()), cur_t.transpose(0, 1),
                                 tsl._traced_decays(col(k_t), col(k_t)))
    assert got.dtype == torch.int32 and torch.equal(got, want.transpose(0, 1))
    assert 0 < int(got.sum()) < got.numel()
    # the feedback add wrapped somewhere (int64 sums past the int32 range)
    acc = cur[:, 1:].astype(np.int64) + got[:, :-1].numpy() * np.int64(W_SELF)[:, None, None, None]
    assert (acc > 2**31 - 1).any() and (acc < -(2**31)).any()


def test_ataf_scan_checks_its_registers():
    cur = torch.zeros(2, 3, 1, 4, dtype=torch.int32)
    good = torch.tensor([5, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"ataf_scan: .* w_self must be int32 \[2\]"):
        ataf_scan(cur, w_self=good[:1], theta_q=good, decay_k=good)
    with pytest.raises(ValueError, match=r"theta_q must be int32 \[2\]"):
        ataf_scan(cur, w_self=good, theta_q=5, decay_k=good)
    with pytest.raises(ValueError, match=r"decay_k must be int32 \[2\]"):
        ataf_scan(cur, w_self=good, theta_q=good, decay_k=good.to(torch.int64))
    with pytest.raises(ValueError, match=r"currents must be \[P, T, B, N\]"):
        ataf_scan(cur[0], w_self=good, theta_q=good, decay_k=good)
    with pytest.raises(ValueError, match="u_bits"):
        ataf_scan(cur, w_self=good, theta_q=good, decay_k=good, u_bits=1)


@pytest.mark.parametrize("neuron,topology,reset", CASES, ids=["-".join(c) for c in CASES])
def test_population_phase_b_takes_one_scan_per_ff_or_ataf_layer(neuron, topology, reset):
    """A sweep's kernel calls by layer: ``lif_scan`` for each feed-forward
    IF/LIF layer, ``ataf_scan`` for each ATA-F IF/LIF layer; ATA-T and
    Synaptic layers call neither (the step loop: only ATA-T's per-step
    ``spike_matmul``)."""
    jn, tn = _nets(neuron, topology, reset)
    _, (tnets, tqs) = _population(jn, tn, candidates=CANDIDATES[:3])
    ts, tb, ta = tbe.stack_population(tnets, tqs)
    with work.Recorder("cpu") as rec:
        tbe.run_int_population(tn, ts, tb, ta, torch.from_numpy(_raster(3, 5, 6, 24)))
    names = [s.name for s in rec.spans]
    ataf = [c.topology == tsl.Topology.ATA_F and c.neuron != tsl.NeuronModel.SYNAPTIC
            for c in tn.layers]
    assert names.count("lif_scan") == sum(map(tsl.fused_eligible, tn.layers))
    assert names.count("ataf_scan") == sum(ataf)
    T = tn.n_steps
    per_step = T * sum(c.topology == tsl.Topology.ATA_T for c in tn.layers)
    assert names.count("spike_matmul") == len(tn.layers) + per_step


def test_check_population_structure_raises_jax_message():
    jn, tn = _nets("lif", "ata_f", "subtract")
    for change in (dict(u_bits=12), dict(threshold=0.7), dict(neuron="if")):
        msgs = []
        for sl, nw, base in ((jsl, jnet, jn), (tsl, tnet, tn)):
            kw = {k: sl.NeuronModel(v) if k == "neuron" else v for k, v in change.items()}
            layers = (base.layers[0], base.layers[1].__class__(**{
                **{f: getattr(base.layers[1], f) for f in base.layers[1].__dataclass_fields__},
                **kw,
            }))
            bad = nw.NetworkConfig(layers=layers, n_steps=base.n_steps, name="bad")
            be = jbe if sl is jsl else tbe
            with pytest.raises(ValueError) as e:
                be.check_population_structure(base, [base, bad])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    short = (jnet.NetworkConfig(layers=jn.layers[:1], n_steps=5, name="short"),
             tnet.NetworkConfig(layers=tn.layers[:1], n_steps=5, name="short"))
    with pytest.raises(ValueError) as ej:
        jbe.check_population_structure(jn, [short[0]])
    with pytest.raises(ValueError) as et:
        tbe.check_population_structure(tn, [short[1]])
    assert str(ej.value) == str(et.value)
    # the knobs may vary
    tbe.check_population_structure(tn, [tn.replace_precisions(w_bits=3, w_rec_bits=9, leak_bits=2)])


def test_eval_int_population_refuses_a_mesh():
    jn, tn = _nets("lif", "ff", "subtract")
    _, (tnets, tqs) = _population(jn, tn, candidates=CANDIDATES[:2])
    _, tds_ = _dataset(24, 4, n=4)
    # a mesh is taken now: an over-ask is refused as JAX's make_mesh refuses
    # it, and 2 shards on the CPU give the one-device sweep's accuracies
    with pytest.raises(ValueError, match="exceeds"):
        ttrain.eval_int_population(tn, tnets, tqs, tds_, mesh=shard.make_mesh().n_shards + 1)
    np.testing.assert_array_equal(
        ttrain.eval_int_population(tn, tnets, tqs, tds_, mesh=shard.make_mesh(2, devices=["cpu"] * 2)),
        ttrain.eval_int_population(tn, tnets, tqs, tds_),
    )
