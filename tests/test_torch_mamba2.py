"""The port's SSD mixer (``models/mamba2.py``) against the JAX package on the CPU.

Every function of the module on the same inputs, made from a seed with
numpy, through both packages.  Tolerances: f32 forward within 1e-5 of the
output's max |value| (the same f32 arithmetic in other summation orders);
gradients within 1e-4 of each leaf's max |g|; ``ssd_scan`` against a numpy
copy of ``tests/test_models.py``'s ``_naive_ssd`` recurrence at the 2e-3
that test allows.  In bf16 compute the dtype of every intermediate equals
JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import mamba2 as jm
from repro_torch.models import mamba2 as tm
from repro_torch.models.common import params_from_numpy

CFG = dict(d_model=32, d_state=8, d_conv=4, expand=2, head_dim=8, chunk=16)


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return jm.SSMConfig(**kw), tm.SSMConfig(**kw)


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _params(jcfg, seed=0):
    """JAX's init, then perturbed so that a_log, dt_bias, d_skip, conv_b and
    norm_w are not their constant inits (the tests would miss a swapped
    leaf otherwise); numpy arrays."""
    p = {k: np.asarray(v) for k, v in jcommon.materialize(
        jax.random.PRNGKey(seed), jm.ssm_template(jcfg)).items()}
    rng = np.random.default_rng(seed)
    for k in ("a_log", "dt_bias", "d_skip", "conv_b", "norm_w"):
        p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def _both(p):
    return {k: jnp.asarray(v) for k, v in p.items()}, params_from_numpy(p, device="cpu")


def test_config_and_template_match_jax():
    for kw in ({}, {"n_groups": 2, "decay_quant_bits": 8}):
        jcfg, tcfg = _cfgs(**kw)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        for prop in ("d_inner", "n_heads", "conv_dim"):
            assert getattr(tcfg, prop) == getattr(jcfg, prop)
        jt, tt_ = jm.ssm_template(jcfg), tm.ssm_template(tcfg)
        assert sorted(jt) == sorted(tt_)
        for k in jt:
            assert (tt_[k].shape, tt_[k].init, tt_[k].scale) == (jt[k].shape, jt[k].init, jt[k].scale), k


def test_split_in_proj_matches_jax():
    jcfg, tcfg = _cfgs(n_groups=2)
    d = 2 * jcfg.d_inner + 2 * jcfg.n_groups * jcfg.d_state + jcfg.n_heads
    v = np.random.default_rng(0).standard_normal((2, 5, d)).astype(np.float32)
    for got, want in zip(tm._split_in_proj(tcfg, torch.from_numpy(v)), jm._split_in_proj(jcfg, jnp.asarray(v))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_state", [False, True], ids=["prefill", "streaming"])
def test_causal_conv_matches_jax(with_state):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    C = jcfg.conv_dim
    xbc = rng.standard_normal((2, 6, C)).astype(np.float32)
    w = rng.standard_normal((jcfg.d_conv, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    st = rng.standard_normal((2, jcfg.d_conv - 1, C)).astype(np.float32) if with_state else None
    j_out, j_new = jm._causal_conv(
        jcfg, jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b), None if st is None else jnp.asarray(st)
    )
    t_out, t_new = tm._causal_conv(
        tcfg, torch.from_numpy(xbc), torch.from_numpy(w), torch.from_numpy(b),
        None if st is None else torch.from_numpy(st),
    )
    _close(t_out, j_out)
    np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))


@pytest.mark.parametrize("bits", [None, 8, 3])
def test_decays_match_jax_and_snap_to_the_cg_grid(bits):
    jcfg, tcfg = _cfgs(decay_quant_bits=bits)
    rng = np.random.default_rng(2)
    H = jcfg.n_heads
    dt_raw = (3 * rng.standard_normal((2, 7, H))).astype(np.float32)
    dt_raw[0, 0, 0] = 30.0  # softplus's linear tail
    bias, a_log = rng.standard_normal(H).astype(np.float32), rng.standard_normal(H).astype(np.float32)
    j_dt, j_a = jm._decays(jcfg, jnp.asarray(dt_raw), jnp.asarray(bias), jnp.asarray(a_log))
    t_dt, t_a = tm._decays(tcfg, torch.from_numpy(dt_raw), torch.from_numpy(bias), torch.from_numpy(a_log))
    assert t_dt.dtype == t_a.dtype == torch.float32
    _close(t_dt, j_dt, 1e-6)
    _close(t_a, j_a, 1e-6)
    if bits is not None:
        k = t_a.numpy() * (1 << bits)
        np.testing.assert_array_equal(k, np.round(k))  # on the k / 2^bits grid
        np.testing.assert_array_equal(t_a.numpy(), np.asarray(j_a))


def test_decay_snap_rounds_half_to_even_with_a_straight_through_gradient():
    """The snap's rounding is jnp.round's (half to even) and its gradient is
    the unquantized decay's."""
    halves = np.array([0.5, 1.5, 2.5, -0.5, 3.5, 254.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(halves)).numpy(), np.asarray(jnp.round(halves)))
    _, tcfg = _cfgs(decay_quant_bits=2)
    H = tcfg.n_heads
    rng = np.random.default_rng(13)
    dt_raw = torch.from_numpy(rng.standard_normal((1, 3, H)).astype(np.float32)).requires_grad_(True)
    bias, a_log = torch.from_numpy(rng.standard_normal((2, H)).astype(np.float32))
    _, a = tm._decays(tcfg, dt_raw, bias, a_log)
    _, plain = tm._decays(dataclasses.replace(tcfg, decay_quant_bits=None), dt_raw, bias, a_log)
    assert not torch.equal(a, plain)
    g, g_plain = (torch.autograd.grad(v.sum(), dt_raw)[0] for v in (a, plain))
    torch.testing.assert_close(g, g_plain, rtol=0, atol=0)


def test_segsum_matches_jax_and_its_mask_carries_no_gradient():
    log_a = np.log(np.random.default_rng(3).uniform(0.2, 1.0, (2, 3, 9))).astype(np.float32)
    j = jm._segsum(jnp.asarray(log_a))
    t = tm._segsum(torch.from_numpy(log_a))
    np.testing.assert_array_equal(np.isinf(t.numpy()), np.isinf(np.asarray(j)))
    fin = np.isfinite(np.asarray(j))
    np.testing.assert_allclose(t.numpy()[fin], np.asarray(j)[fin], rtol=0, atol=1e-6)
    x = torch.from_numpy(log_a).requires_grad_(True)
    g = torch.autograd.grad(torch.exp(tm._segsum(x)).sum(), x)[0]
    jg = jax.grad(lambda v: jnp.exp(jm._segsum(v)).sum())(jnp.asarray(log_a))
    assert bool(torch.isfinite(g).all())
    _close(g, jg, 1e-5)


def _scan_inputs(Bb, L, H, P, G, N, seed):
    """tests/test_models.py's construction, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((Bb, L, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, L, H)))).astype(np.float32)
    a = np.exp(-dt * np.exp(rng.standard_normal(H) * 0.2)[None, None]).astype(np.float32)
    B = (rng.standard_normal((Bb, L, G, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((Bb, L, G, N)) * 0.5).astype(np.float32)
    return x, dt, a, B, C


def _naive_ssd(x, dt, a, B, C):
    """tests/test_models.py's token-by-token recurrence (float64)."""
    Bb, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    h = np.zeros((Bb, H, P, N))
    ys = np.zeros((Bb, L, H, P))
    for t in range(L):
        Bt = np.repeat(B[:, t], rep, axis=1)
        Ct = np.repeat(C[:, t], rep, axis=1)
        xt = x[:, t] * dt[:, t][..., None]
        h = h * a[:, t][..., None, None] + np.einsum("bhn,bhp->bhpn", Bt, xt)
        ys[:, t] = np.einsum("bhn,bhpn->bhp", Ct, h)
    return ys, h


@pytest.mark.parametrize(
    "L,G,init",
    [(64, 1, False), (16, 1, False), (48, 2, True), (8, 1, True)],
    ids=["4-chunks", "1-chunk", "groups-2-init", "short-init"],
)
def test_ssd_scan_matches_jax_and_the_naive_recurrence(L, G, init):
    jcfg, tcfg = _cfgs()
    Bb, H, P, N = 2, 4, 8, 8
    x, dt, a, B, C = _scan_inputs(Bb, L, H, P, G, N, seed=L + G)
    h0 = np.random.default_rng(4).standard_normal((Bb, H, P, N)).astype(np.float32) if init else None
    jy, jh = jm.ssd_scan(jcfg, *map(jnp.asarray, (x, dt, a, B, C)), None if h0 is None else jnp.asarray(h0))
    ty, th = tm.ssd_scan(tcfg, *map(torch.from_numpy, (x, dt, a, B, C)), None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)
    if h0 is None:
        y_ref, h_ref = _naive_ssd(x, dt, a, B, C)
        np.testing.assert_allclose(ty.numpy(), y_ref, atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(th.numpy(), h_ref, atol=2e-3, rtol=2e-3)


def test_ssd_scan_refuses_a_ragged_sequence():
    _, tcfg = _cfgs()
    x, dt, a, B, C = _scan_inputs(1, 24, 4, 8, 1, 8, seed=0)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tm.ssd_scan(tcfg, *map(torch.from_numpy, (x, dt, a, B, C)))


@pytest.mark.parametrize("bits", [None, 6])
def test_ssm_apply_matches_jax(bits):
    jcfg, tcfg = _cfgs(decay_quant_bits=bits, n_groups=2)
    jp, tp = _both(_params(jcfg, seed=5))
    x = np.random.default_rng(6).standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    jy, js, jc = jm.ssm_apply(jcfg, jp, jnp.asarray(x))
    ty, ts, tc = tm.ssm_apply(tcfg, tp, torch.from_numpy(x))
    _close(ty, jy)
    _close(ts, js)
    _close(tc, jc)


@pytest.mark.parametrize("bits", [None, 6])
def test_ssm_apply_gradients_match_jax(bits):
    """The gradients of a scalar of the output, the final state and the
    conv state with respect to every parameter and the input; with
    ``decay_quant_bits`` the straight-through gradient."""
    jcfg, tcfg = _cfgs(decay_quant_bits=bits)
    jp, tp = _both(_params(jcfg, seed=7))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    wy = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, s, c = jm.ssm_apply(jcfg, p, x)
        return jnp.sum(y * wy) + 0.1 * jnp.sum(s**2) + 0.1 * jnp.sum(jnp.sin(c))

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    y, s, c = tm.ssm_apply(tcfg, leaves, tx)
    loss = torch.sum(y * torch.from_numpy(wy)) + 0.1 * torch.sum(s**2) + 0.1 * torch.sum(torch.sin(c))
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [tx])
    for k, g in zip(names, grads):
        _close(g, jg_p[k], 1e-4)
    _close(grads[-1], jg_x, 1e-4)


def test_ssm_cache_init_and_template():
    jcfg, tcfg = _cfgs()
    jt = jm.ssm_cache_template(jcfg, 3)
    tt_ = tm.ssm_cache_template(tcfg, 3)
    assert {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in tt_.items()} == {
        k: (tuple(v.shape), v.dtype.name) for k, v in jt.items()
    }
    c = tm.ssm_cache_init(tcfg, 3, device="cpu")
    assert all(v.dtype == torch.float32 and not v.any() for v in c.values())
    assert {k: tuple(v.shape) for k, v in c.items()} == {k: s for k, (s, _) in tt_.items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.ssm_cache_init(tcfg, 1)


@pytest.mark.parametrize("bits", [None, 4])
def test_ssm_decode_step_matches_jax_and_continues_the_prefill(bits):
    """Five decode steps against JAX's from a prefill's caches; the port's
    steps also equal a one-pass ``ssm_apply`` over the whole sequence."""
    jcfg, tcfg = _cfgs(decay_quant_bits=bits)
    jp, tp = _both(_params(jcfg, seed=9))
    x = np.random.default_rng(10).standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    _, js, jc = jm.ssm_apply(jcfg, jp, jnp.asarray(x[:, :16]))
    _, ts, tc = tm.ssm_apply(tcfg, tp, torch.from_numpy(x[:, :16]))
    jcache, tcache = {"conv": jc, "state": js}, {"conv": tc.float(), "state": ts}
    outs = []
    for t in range(16, 21):
        jy, jcache = jm.ssm_decode_step(jcfg, jp, jcache, jnp.asarray(x[:, t : t + 1]))
        ty, new = tm.ssm_decode_step(tcfg, tp, tcache, torch.from_numpy(x[:, t : t + 1]))
        assert new["conv"] is not tcache["conv"] and new["state"] is not tcache["state"]
        tcache = new
        _close(ty, jy)
        outs.append(ty)
    _close(tcache["state"], jcache["state"])
    _close(tcache["conv"], jcache["conv"])
    if bits is None:  # 21 tokens = 16 + 5: the same recurrence
        tcfg21 = dataclasses.replace(tcfg, chunk=21)
        full, state, conv = tm.ssm_apply(tcfg21, tp, torch.from_numpy(x))
        _close(torch.cat(outs, dim=1), full[:, 16:], 1e-4)
        _close(tcache["state"], state, 1e-4)
        _close(tcache["conv"], conv, 1e-6)


def _dtypes_jax(cfg, p, x, cache):
    """Every intermediate's dtype name through the JAX module's steps."""
    zxbcdt = jm.qdot(x, p["in_proj"])
    z, xbc, dt_raw = jm._split_in_proj(cfg, zxbcdt)
    conv_out, conv_state = jm._causal_conv(cfg, xbc, p["conv_w"], p["conv_b"], None if cache is None else cache["conv"])
    dt, a = jm._decays(cfg, dt_raw, p["dt_bias"], p["a_log"])
    if cache is None:
        y, state, conv = jm.ssm_apply(cfg, p, x)
        new = {"conv": conv, "state": state}
    else:
        y, new = jm.ssm_decode_step(cfg, p, cache, x)
    return [t.dtype.name for t in (zxbcdt, z, xbc, conv_out, conv_state, dt, a, y, new["conv"], new["state"])]


def _dtypes_torch(cfg, p, x, cache):
    zxbcdt = tm.qdot(x, p["in_proj"])
    z, xbc, dt_raw = tm._split_in_proj(cfg, zxbcdt)
    conv_out, conv_state = tm._causal_conv(cfg, xbc, p["conv_w"], p["conv_b"], None if cache is None else cache["conv"])
    dt, a = tm._decays(cfg, dt_raw, p["dt_bias"], p["a_log"])
    if cache is None:
        y, state, conv = tm.ssm_apply(cfg, p, x)
        new = {"conv": conv, "state": state}
    else:
        y, new = tm.ssm_decode_step(cfg, p, cache, x)
    return [str(t.dtype).removeprefix("torch.") for t in (zxbcdt, z, xbc, conv_out, conv_state, dt, a, y, new["conv"], new["state"])]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_bf16_intermediate_dtypes_match_jax(mode):
    """bf16 activations with f32 parameters, as the LM runs them: the
    in_proj output is bf16; the f32 conv weight promotes the conv output
    to f32 (prefill), the f32 conv state promotes the window (decode: the
    bf16 token is concatenated to it); dt, a and the state are f32; y
    returns to bf16.  Train and prefill run the same mixer."""
    jcfg, tcfg = _cfgs()
    jp, tp = _both(_params(jcfg, seed=11))
    L = 1 if mode == "decode" else 16
    x = np.random.default_rng(12).standard_normal((2, L, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    jcache = tcache = None
    if mode == "decode":
        jcache = jm.ssm_cache_init(jcfg, 2)
        tcache = tm.ssm_cache_init(tcfg, 2, device="cpu")
    want = _dtypes_jax(jcfg, jp, jx, jcache)
    got = _dtypes_torch(tcfg, tp, tx, tcache)
    assert got == want
    assert want[3] == "float32" and want[7] == "bfloat16"
    # the promotions the port relies on, as jnp promotes
    b, f = torch.ones(2, 1, dtype=torch.bfloat16), torch.ones(2, 1)
    jb, jf = jnp.ones((2, 1), jnp.bfloat16), jnp.ones((2, 1))
    assert str(torch.cat([f, b], 1).dtype).removeprefix("torch.") == jnp.concatenate([jf, jb], 1).dtype.name
    assert str((b * f).dtype).removeprefix("torch.") == (jb * jf).dtype.name
