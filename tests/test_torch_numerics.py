"""Parity of the port's integer numerics with the JAX package (exact equality).

Fixed-point primitives, the coefficient generator, quantization, the
datasets and the hardware model: the same numpy inputs go through
``repro`` and ``repro_torch`` and must give identical results.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coeff_gen as jcg
from repro.core import fixed_point as jfp
from repro.core import hw_model as jhw
from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.data import snn_datasets as jds
from repro_torch.core import coeff_gen as tcg
from repro_torch.core import fixed_point as tfp
from repro_torch.core import hw_model as thw
from repro_torch.core import network as tnet
from repro_torch.core import snn_layer as tsl
from repro_torch.data import snn_datasets as tds

I32_EDGES = np.array(
    [-(2**31), -(2**31) + 1, -(2**24), -65536, -32769, -32768, -257, -7, -1, 0, 1, 7, 255,
     32767, 32768, 2**24, 2**31 - 2, 2**31 - 1],
    np.int32,
)


def _ints(seed, n=512, lo=-(2**20), hi=2**20):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(lo, hi, n).astype(np.int32), I32_EDGES])


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(a_torch, b_jax):
    np.testing.assert_array_equal(np.asarray(a_torch.cpu()), np.asarray(b_jax))


def test_int_range_helpers():
    for bits in range(2, 32):
        assert tfp.int_min(bits) == jfp.int_min(bits)
        assert tfp.int_max(bits) == jfp.int_max(bits)


@pytest.mark.parametrize("bits", [4, 8, 12, 16, 24])
def test_saturate_and_sat_add(bits):
    a, b = _ints(bits), _ints(bits + 100)
    _eq(tfp.saturate(_t(a), bits), jfp.saturate(jnp.asarray(a), bits))
    _eq(tfp.sat_add(_t(a), _t(b), bits), jfp.sat_add(jnp.asarray(a), jnp.asarray(b), bits))


@pytest.mark.parametrize("n", range(0, 9))
def test_arithmetic_rshift_negative_values(n):
    x = _ints(n, lo=-(2**31), hi=2**31 - 1)
    got = tfp.arithmetic_rshift(_t(x), n)
    _eq(got, jfp.arithmetic_rshift(jnp.asarray(x), n))
    assert tfp.arithmetic_rshift(torch.tensor([-7], dtype=torch.int32), 1).item() == -4


@pytest.mark.parametrize("bits,scale", [(6, 31.7), (8, 127.0), (3, 2.5), (16, 1000.25)])
def test_quantize_symmetric(bits, scale):
    x = np.random.default_rng(bits).normal(0, 1.5, 1000).astype(np.float32)
    x[:4] = [0.5 / scale, 1.5 / scale, -2.5 / scale, 1e9]  # half-to-even ties, clip
    _eq(tfp.quantize_symmetric(x, bits, scale), jfp.quantize_symmetric(x, bits, scale))


@pytest.mark.parametrize("leak_bits", range(1, 9))
def test_encode_decay_grid(leak_bits):
    for beta in np.linspace(0.0, 1.0, 97):
        assert dataclasses.astuple(tcg.encode_decay(float(beta), leak_bits)) == dataclasses.astuple(
            jcg.encode_decay(float(beta), leak_bits)
        )
    np.testing.assert_array_equal(
        tcg.quantization_grid(leak_bits), jcg.quantization_grid(leak_bits)
    )


@pytest.mark.parametrize("leak_bits", range(1, 9))
def test_apply_decay_every_code(leak_bits):
    """Every representable code at this tap budget, static and register forms."""
    x = _ints(leak_bits, lo=-(2**23), hi=2**23)
    step = 1 << (8 - leak_bits)
    for k in list(range(0, 256, step)) + [256]:
        jcode = jcg.DecayCode(k=k % 256, bypass=k == 256, leak_bits=leak_bits)
        tcode = tcg.DecayCode(k=k % 256, bypass=k == 256, leak_bits=leak_bits)
        want = jcg.apply_decay(jnp.asarray(x), jcode)
        _eq(tcg.apply_decay(_t(x), tcode), want)
        _eq(tcg.apply_decay_traced(_t(x), tcode.decay_rate_register), want)


# tests/test_coeff_gen.py's anchors, re-pointed at the port


def test_paper_example_k153():
    code = tcg.encode_decay(0.59765625, leak_bits=8)
    assert (code.k, code.bypass, code.decay_rate_register) == (153, False, 0b010011001)
    assert tcg.decode_factor(code) == code.factor == jcg.decode_factor(jcg.encode_decay(0.59765625))


def test_bypass_is_if_model():
    code = tcg.encode_decay(1.0, leak_bits=8)
    assert code.bypass
    x = torch.arange(-5, 6, dtype=torch.int32) * 37
    assert torch.equal(tcg.apply_decay(x, code), x)


def test_selection_units_gating():
    assert [tcg.selection_units(b) for b in (0, 2, 3, 8)] == [0b0000, 0b0001, 0b0011, 0b1111]
    for leak_bits in range(0, 9):
        assert tcg.selection_units(leak_bits) == jcg.selection_units(leak_bits)
    for bad in (-1, 9):
        with pytest.raises(ValueError, match="leak_bits"):
            tcg.selection_units(bad)


@pytest.mark.parametrize("leak_bits", [1, 3, 8])
def test_decay_float_and_error_bound_every_code(leak_bits):
    """``decode_factor``, ``max_value_error_bound`` and ``apply_decay_float``
    equal JAX's for every code at the budget, and the bound holds."""
    x = _ints(leak_bits + 20, lo=-(2**20), hi=2**20)
    step = 1 << (8 - leak_bits)
    for k in list(range(0, 256, step)) + [256]:
        tcode = tcg.DecayCode(k=k % 256, bypass=k == 256, leak_bits=leak_bits)
        jcode = jcg.DecayCode(k=k % 256, bypass=k == 256, leak_bits=leak_bits)
        assert tcg.decode_factor(tcode) == jcg.decode_factor(jcode)
        bound = tcg.max_value_error_bound(tcode)
        assert bound == jcg.max_value_error_bound(jcode)
        approx = tcg.apply_decay_float(_t(x), tcode)
        assert approx.dtype == torch.float32
        _eq(approx, jcg.apply_decay_float(jnp.asarray(x), jcode))
        exact = tcg.apply_decay(_t(x), tcode).to(torch.float64)
        assert float((exact - _t(x).to(torch.float64) * tcode.factor).abs().max()) <= bound


@pytest.mark.parametrize("bits,margin", [(6, 1.0), (8, 1.25), (3, 0.5), (16, 1.0)])
def test_quant_spec_matches_jax(bits, margin):
    x = np.random.default_rng(bits).normal(0, 0.4, 257).astype(np.float32)
    tspec = tfp.make_spec_from_absmax(torch.from_numpy(x), bits, margin)
    jspec = jfp.make_spec_from_absmax(x, bits, margin)
    assert dataclasses.astuple(tspec) == dataclasses.astuple(jspec)
    assert (tspec.qmin, tspec.qmax) == (jspec.qmin, jspec.qmax)
    q = tspec.quantize(_t(x))
    _eq(q, jspec.quantize(jnp.asarray(x)))
    _eq(tspec.dequantize(q), jspec.dequantize(jnp.asarray(q.numpy())))
    _eq(tfp.dequantize(q, 3.3333), jfp.dequantize(jnp.asarray(q.numpy()), 3.3333))
    empty = tfp.make_spec_from_absmax(np.zeros(0, np.float32), bits)
    assert dataclasses.astuple(empty) == dataclasses.astuple(jfp.make_spec_from_absmax(
        np.zeros(0, np.float32), bits))


def _float_arrays(net, seed):
    """Float parameters from a numpy seed: uniform(+-1/sqrt(fan_in)) weights."""
    rng = np.random.default_rng(seed)
    arrays = []
    for cfg in net.layers:
        lim = 1 / np.sqrt(cfg.n_in)
        w_ff = rng.uniform(-lim, lim, (cfg.n_in, cfg.n_out)).astype(np.float32)
        if cfg.topology.value == "ata_t":
            w_rec = rng.uniform(-0.3, 0.3, (cfg.n_out, cfg.n_out)).astype(np.float32)
        elif cfg.topology.value == "ata_f":
            w_rec = np.float32(0.1)
        else:
            w_rec = np.zeros(0, np.float32)
        arrays.append((w_ff, w_rec, np.float32(cfg.threshold)))
    return arrays


QUANT_NETS = [
    dict(topology=jsl.Topology.FF, w_bits=6, u_bits=16),
    dict(topology=jsl.Topology.ATA_T, w_bits=4, w_rec_bits=5, u_bits=8),
    dict(topology=jsl.Topology.ATA_F, w_bits=8, w_rec_bits=3, u_bits=12),
    dict(topology=jsl.Topology.FF, w_bits=2, u_bits=4, threshold=0.0),
]


def _pair_nets(n_in, hidden, n_out, T, **kw):
    """The same network config in both packages (enums by value)."""
    def mk(sl, nw):
        kw1 = {k: (getattr(sl, type(v).__name__)(v.value) if hasattr(v, "value") else v)
               for k, v in kw.items()}
        return nw.NetworkConfig(
            layers=(
                sl.LayerConfig(n_in=n_in, n_out=hidden, **kw1),
                sl.LayerConfig(n_in=hidden, n_out=n_out, w_bits=kw1.get("w_bits", 6),
                               u_bits=kw1.get("u_bits", 16)),
            ),
            n_steps=T,
        )
    return mk(jsl, jnet), mk(tsl, tnet)


@pytest.mark.parametrize("kw", QUANT_NETS, ids=["ff", "ata_t", "ata_f", "theta0"])
def test_quantize_params_bit_equal(kw):
    jn, tn = _pair_nets(40, 24, 10, 6, **kw)
    arrays = _float_arrays(jn, seed=3)
    if kw.get("threshold") == 0.0:
        arrays = [(w, r, np.float32(0.0)) for w, r, _ in arrays]
    jq, js = jnet.quantize_params(jn, [jsl.FloatLayerParams(*map(jnp.asarray, a)) for a in arrays])
    tq, ts = tnet.quantize_params(tn, tnet.float_params_from_numpy(tn, arrays, device="cpu"))
    assert ts == js
    for a, b in zip(tq, jq):
        for fa, fb in zip(a, b):
            assert fa.dtype == torch.int32
            _eq(fa, fb)


def test_paper_width_quantization_bit_equal():
    """The 256-128-10 design point at w6/u16: scales, theta_q and weights."""
    layers = lambda sl: (sl.LayerConfig(n_in=256, n_out=128), sl.LayerConfig(n_in=128, n_out=10))
    jn = jnet.NetworkConfig(layers=layers(jsl), n_steps=25)
    tn = tnet.NetworkConfig(layers=layers(tsl), n_steps=25)
    arrays = _float_arrays(jn, seed=0)
    jq, js = jnet.quantize_params(jn, [jsl.FloatLayerParams(*map(jnp.asarray, a)) for a in arrays])
    tq, ts = tnet.quantize_params(tn, tnet.float_params_from_numpy(tn, arrays, device="cpu"))
    assert ts == js
    for a, b in zip(tq, jq):
        for fa, fb in zip(a, b):
            _eq(fa, fb)


def test_init_float_params_seeded_and_device_default():
    net = tnet.NetworkConfig(
        layers=(tsl.LayerConfig(n_in=16, n_out=8, topology=tsl.Topology.ATA_T),
                tsl.LayerConfig(n_in=8, n_out=4)),
        n_steps=4,
    )
    a = tnet.init_float_params(torch.Generator().manual_seed(5), net, device="cpu")
    b = tnet.init_float_params(torch.Generator().manual_seed(5), net, device="cpu")
    for pa, pb in zip(a, b):
        for x, y in zip(pa, pb):
            assert torch.equal(x, y)
    assert a[0].w_rec.shape == (8, 8) and a[1].w_rec.shape == (0,)
    assert float(a[0].w_ff.abs().max()) <= 1 / np.sqrt(16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnet.init_float_params(torch.Generator().manual_seed(5), net)


@pytest.mark.parametrize(
    "make,kw",
    [("mnist_like", dict(n=12, T=7, seed=4)), ("shd_like", dict(n=6, T=9, seed=2)),
     ("dvs_like", dict(n=6, T=5, seed=1))],
)
def test_datasets_equal_for_equal_seeds(make, kw):
    a, b = getattr(tds, make)(**kw), getattr(jds, make)(**kw)
    np.testing.assert_array_equal(a.spikes, b.spikes)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert (a.n_classes, a.name) == (b.n_classes, b.name)
    for (xs, ls), (ys, ms) in zip(a.batches(5), b.batches(5)):
        np.testing.assert_array_equal(xs, ys)
        np.testing.assert_array_equal(ls, ms)
    (xs, _), = list(a.batches(len(a.labels)))
    x0 = tds.raster_tensor(xs, device="cpu")
    assert x0.dtype == torch.int32 and x0.shape == (kw["T"], kw["n"], a.spikes.shape[2])
    np.testing.assert_array_equal(x0.numpy(), xs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tds.raster_tensor(xs)


def _paper_nets():
    layers = lambda sl: (
        sl.LayerConfig(n_in=256, n_out=128, w_bits=6, u_bits=8),
        sl.LayerConfig(n_in=128, n_out=10, w_bits=6, u_bits=8),
    )
    return (
        jnet.NetworkConfig(layers=layers(jsl), n_steps=100),
        tnet.NetworkConfig(layers=layers(tsl), n_steps=100),
    )


def test_paper_design_point_reproduced_exactly():
    _, net = _paper_nets()
    res = thw.network_resources(net)
    assert res.lut == pytest.approx(934, abs=1.0)
    assert res.ff == pytest.approx(689, abs=1.0)
    assert res.bram == 7
    traffic = thw.paper_mnist_traffic()
    lat = thw.latency_seconds(net, traffic)
    assert lat == pytest.approx(1.1e-3, rel=1e-9)
    e_img = thw.energy_per_image(net, lat, traffic)
    assert e_img == pytest.approx(0.12e-3, rel=1e-9)
    dp = thw.design_point(net, traffic)
    assert dp.latency_s == lat and dp.energy_per_image_j == e_img


@pytest.mark.parametrize("topology", ["ff", "ata_t", "ata_f"])
def test_design_point_equal_for_equal_traffic(topology):
    jn, tn = _pair_nets(64, 32, 10, 12, topology=jsl.Topology(topology), u_bits=12)
    rng = np.random.default_rng(7)
    stats = {
        "input_events_per_step": rng.uniform(0, 20, 12),
        "layer_events_per_step": [rng.uniform(0, 8, 12), rng.uniform(0, 2, 12)],
    }
    a = thw.design_point(tn, thw.EventTraffic.from_stats(stats))
    b = jhw.design_point(jn, jhw.EventTraffic.from_stats(stats))
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert dataclasses.astuple(thw.network_resources(tn)) == dataclasses.astuple(
        jhw.network_resources(jn)
    )


def test_exact_f32_matmul_refuses_tf32():
    x = torch.ones(3, 4, dtype=torch.int32)
    w = torch.full((4, 2), 5, dtype=torch.int32)
    assert torch.equal(tfp.exact_f32_matmul(x, w), torch.full((3, 2), 20, dtype=torch.int32))
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            tfp.exact_f32_matmul(x, w)
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("kw", QUANT_NETS[:3], ids=["ff", "ata_t", "ata_f"])
def test_layer_scale_overrides_match_jax(kw):
    """``w_max`` / ``rec_max`` given (as the refine phase passes them): the
    scale equals JAX's, and the defaults equal the config's maxima."""
    jn, tn = _pair_nets(24, 12, 5, 4, **kw)
    arrays = _float_arrays(jn, 7)
    jp = [jsl.FloatLayerParams(*(jnp.asarray(a) for a in layer)) for layer in arrays]
    tp = tnet.float_params_from_numpy(tn, arrays, "cpu")
    for jc, tc, a, b in zip(jn.layers, tn.layers, jp, tp):
        for w_max, rec_max in [(None, None), (1.0, 127.0), (31.0, 3.0), (32767.0, None)]:
            want = jnet.layer_scale(jc, a, w_max, rec_max)
            got = tnet.layer_scale(tc, b, w_max, rec_max)
            assert got.dtype == torch.float32 and got.shape == ()
            _eq(got, want)
