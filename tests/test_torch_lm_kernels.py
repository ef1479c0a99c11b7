"""The port's LM kernel modules and attention against the JAX package.

On the CPU ``quant_matmul`` and ``flash_attention`` run their plain
versions; these tests hold them to the JAX Pallas kernels in interpret mode
over the cases of ``tests/test_kernels.py`` (``QM_CASES``, ``FA_CASES``), at
the tolerances stated there, and hold the port's attention functions to the
JAX ones.  The card-only tests (marker ``cuda``) are in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import quantize_weight as j_quantize_weight
from repro.kernels.flash_attention.flash_attention import flash_attention as j_flash_attention
from repro.kernels.quant_matmul.quant_matmul import quant_matmul as j_quant_matmul
from repro.kernels.quant_matmul.ref import quant_matmul_ref as j_quant_matmul_ref
from repro.models import attention as ja
from repro_torch import kernels
from repro_torch.core.precision import qdot, quantize_weight
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import flash_attend
from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul
from repro_torch.models import attention as ta

# (bits, M, K, N, dtype), tests/test_kernels.py QM_CASES
QM_CASES = [
    (8, 256, 1024, 256, "bfloat16"),
    (8, 128, 512, 128, "float32"),
    (6, 128, 512, 128, "bfloat16"),
    (5, 128, 1024, 256, "bfloat16"),
    (4, 128, 512, 256, "bfloat16"),
    (4, 256, 1536, 512, "bfloat16"),
]

# tests/test_kernels.py FA_CASES
FA_CASES = [
    ((2, 4, 512, 512, 64), dict(causal=True)),
    ((1, 2, 1024, 1024, 128), dict(causal=True, window=256)),
    ((1, 2, 512, 512, 64), dict(causal=True, softcap=50.0)),
    ((1, 2, 256, 512, 64), dict(causal=False)),
    ((1, 1, 256, 256, 128), dict(causal=True, window=64, softcap=30.0)),
]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32) if dtype else np.asarray(a)))
    return t.to(getattr(torch, dtype)) if dtype else t


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _qm_tol(dtype):
    # as tests/test_kernels.py: both sides accumulate in f32 in different K
    # orders; a near-tie can land 2 bf16 ulps apart after the final cast
    return dict(rtol=2**-7 if dtype == "bfloat16" else 0, atol=1e-5)


def test_wrappers_list_all_five_kernels():
    assert set(build.KERNELS) == {
        "spike_matmul", "lif_scan", "sparse_accum", "quant_matmul", "flash_attention",
    }
    # ataf_scan is a second kernel of lif_scan's source
    assert set(kernels.wrappers()) == set(build.KERNELS) | {"ataf_scan"}


@pytest.mark.parametrize("bits,M,K,N,dtype", QM_CASES)
def test_quant_matmul_matches_jax_kernel(bits, M, K, N, dtype):
    rng = np.random.default_rng(bits * M)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32)).astype(getattr(jnp, dtype))
    jqt = j_quantize_weight(jnp.asarray(w), bits)
    want = j_quant_matmul(x, jqt.q, jqt.scale, bits=bits, interpret=True, out_dtype=x.dtype)
    qt = quantize_weight(torch.from_numpy(w), bits)
    got = quant_matmul(_t(x, dtype), qt.q, qt.scale, bits=bits)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), **_qm_tol(dtype))


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_qdot_ragged_shapes_match_jax_oracle(bits):
    """Shapes that do not tile (the JAX wrapper falls back to its oracle;
    the port's kernel masks them): x [2, 5, 96] x [96, 24]."""
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((96, 24)) * 0.05).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((2, 5, 96)).astype(np.float32)).astype(jnp.bfloat16)
    want = j_quant_matmul_ref(x, j_quantize_weight(jnp.asarray(w), bits))
    got = qdot(_t(x, "bfloat16"), quantize_weight(torch.from_numpy(w), bits))
    assert got.shape == (2, 5, 24)
    np.testing.assert_allclose(_f32(got), _f32(want), **_qm_tol("bfloat16"))


def test_quant_matmul_refuses_mismatched_operands():
    qt = quantize_weight(torch.randn(16, 8), 4)
    with pytest.raises(ValueError):
        quant_matmul(torch.randn(3, 16), qt.q, qt.scale, bits=8)  # packed q read as int8
    with pytest.raises(ValueError):
        quant_matmul(torch.randn(3, 15), qt.q, qt.scale, bits=4)
    with pytest.raises(ValueError):
        quant_matmul(torch.randn(3, 16), qt.q, qt.scale, bits=3)


def _qkv(shape, seed, hk=None):
    B, H, Sq, Sk, D = shape
    rng = np.random.default_rng(seed)
    mk = lambda h, s: jnp.asarray(rng.standard_normal((B, h, s, D)).astype(np.float32)).astype(
        jnp.bfloat16
    )
    return mk(H, Sq), mk(hk or H, Sk), mk(hk or H, Sk)


@pytest.mark.parametrize("shape,kwargs", FA_CASES)
def test_flash_attention_matches_jax_kernel(shape, kwargs):
    q, k, v = _qkv(shape, shape[2] + shape[4])
    want = j_flash_attention(q, k, v, bq=128, bk=128, interpret=True, **kwargs)
    got = flash_attention(_t(q, "bfloat16"), _t(k, "bfloat16"), _t(v, "bfloat16"), **kwargs)
    assert got.dtype == torch.bfloat16
    # bf16 inputs, f32 accumulation on both sides (tests/test_kernels.py)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=0.05, rtol=0.05)


@pytest.mark.parametrize("shape,kwargs", FA_CASES[:3])
def test_attend_chunked_matches_jax_attend(shape, kwargs):
    """The port's attend_chunked (CPU: query-chunked plain code) against JAX
    ``attend`` in model layout, q_chunk 256 so the chunked branch runs."""
    q, k, v = (x.transpose(0, 2, 1, 3) for x in _qkv(shape, 7))
    mask_j = ja.AttnMask(causal=kwargs["causal"], window=kwargs.get("window"))
    mask_t = ta.AttnMask(causal=kwargs["causal"], window=kwargs.get("window"))
    want = ja.attend(q, k, v, mask=mask_j, softcap=kwargs.get("softcap"))
    got = ta.attend_chunked(
        _t(q, "bfloat16"), _t(k, "bfloat16"), _t(v, "bfloat16"), mask=mask_t,
        softcap=kwargs.get("softcap"), q_chunk=256,
    )
    np.testing.assert_allclose(_f32(got), _f32(want), atol=0.05, rtol=0.05)


def test_flash_gqa_wrapper_matches_jax_attend():
    """tests/test_kernels.py::test_flash_gqa_wrapper, through the port's
    flash_attend (no repeat of the kv heads in the kernel's layout)."""
    q, k, v = _qkv((2, 8, 256, 256, 64), 9, hk=2)
    q, k, v = (x.transpose(0, 2, 1, 3) for x in (q, k, v))  # [B, S, H, D]
    want = ja.attend(q, k, v, mask=ja.AttnMask(causal=True))
    got = flash_attend(_t(q, "bfloat16"), _t(k, "bfloat16"), _t(v, "bfloat16"), causal=True)
    assert got.shape == (2, 256, 8, 64)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=0.05, rtol=0.05)


def _f32_close(got, want):
    # f32 on both sides; transcendental and summation-order differences only
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("frac", [1.0, 0.25])
def test_rope_matches_jax(frac):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    rot = int(32 * frac)
    want = ja.rope(jnp.asarray(x[..., :rot]), jnp.asarray(pos))
    got = ta.rope(torch.from_numpy(x[..., :rot]), torch.from_numpy(pos))
    _f32_close(got, want)
    want = ja.rope(jnp.asarray(x), jnp.arange(7))  # 1-D positions broadcast over batch
    _f32_close(ta.rope(torch.from_numpy(x), torch.arange(7)), want)


def test_mrope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 128)).astype(np.float32)
    pos3 = rng.integers(0, 300, (3, 2, 5)).astype(np.int32)
    want = ja.mrope(jnp.asarray(x), jnp.asarray(pos3))
    _f32_close(ta.mrope(torch.from_numpy(x), torch.from_numpy(pos3)), want)


@pytest.mark.parametrize(
    "kwargs", [dict(), dict(window=3, softcap=20.0), dict(causal=False, kv_valid=True)]
)
def test_attend_matches_jax_f32(kwargs):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    qp, kp = np.arange(3, 9, dtype=np.int32), np.arange(9, dtype=np.int32)
    kv_len = np.array([9, 5], np.int32) if kwargs.get("kv_valid") else None
    mk = dict(causal=kwargs.get("causal", True), window=kwargs.get("window"))
    want = ja.attend(
        *map(jnp.asarray, (q, k, v)), mask=ja.AttnMask(**mk), q_positions=jnp.asarray(qp),
        k_positions=jnp.asarray(kp), softcap=kwargs.get("softcap"),
        kv_valid_len=None if kv_len is None else jnp.asarray(kv_len),
    )
    got = ta.attend(
        *map(torch.from_numpy, (q, k, v)), mask=ta.AttnMask(**mk), q_positions=torch.from_numpy(qp),
        k_positions=torch.from_numpy(kp), softcap=kwargs.get("softcap"),
        kv_valid_len=None if kv_len is None else torch.from_numpy(kv_len),
    )
    _f32_close(got, want)


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("window", [None, 4])
def test_kv_append_and_decode_attend_match_jax(int8_kv, window):
    """Two appends then one decode attention, f32 (or int8 with the
    dequantizing ``kv_inv_scale``), cache lengths 0 / 7 / 15 of 16 slots
    (the last clamps its write to the final slot as dynamic_update_slice does)."""
    rng = np.random.default_rng(4)
    B, S, Hk, Hq, D = 3, 16, 2, 4, 8
    dtype = np.int8 if int8_kv else np.float32
    ck = (rng.standard_normal((B, S, Hk, D)) * (40 if int8_kv else 1)).astype(dtype)
    cv = (rng.standard_normal((B, S, Hk, D)) * (40 if int8_kv else 1)).astype(dtype)
    lens = np.array([0, 7, 15], np.int32)
    news = [(rng.standard_normal((B, 1, Hk, D)) * (40 if int8_kv else 1)).astype(dtype) for _ in range(4)]
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    inv = 1.0 / 32.0 if int8_kv else None

    jc = {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "len": jnp.asarray(lens)}
    tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()), "len": torch.from_numpy(lens.copy())}
    for kn, vn in (news[:2], news[2:]):
        jc = ja.KVCache.append_one(jc, jnp.asarray(kn), jnp.asarray(vn))
        ta.KVCache.append_one(tc, torch.from_numpy(kn), torch.from_numpy(vn))
    for name in ("k", "v", "len"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    want = ja.decode_attend(jnp.asarray(q), jc, softcap=30.0, window=window, kv_inv_scale=inv)
    got = ta.decode_attend(torch.from_numpy(q), tc, softcap=30.0, window=window, kv_inv_scale=inv)
    _f32_close(got, want)


def test_attend_chunked_cpu_keeps_jax_positions_semantics():
    """Non-arange positions are fine on the CPU (the plain path); only the
    card's kernel refuses them."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 8, 2, 16)).astype(np.float32) for _ in range(3))
    pos = np.arange(10, 18, dtype=np.int32)
    want = ja.attend_chunked(*map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(pos),
                             k_positions=jnp.asarray(pos), q_chunk=4)
    got = ta.attend_chunked(*map(torch.from_numpy, (q, k, v)), q_positions=torch.from_numpy(pos),
                            k_positions=torch.from_numpy(pos), q_chunk=4)
    _f32_close(got, want)


@pytest.mark.parametrize("plus_one", [False, True])
def test_norms_match_jax(plus_one):
    from repro.models import common as jc
    from repro_torch.models import common as tc

    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 5, 64)) * 3).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = jc.rms_norm(jnp.asarray(x), jnp.asarray(w), plus_one=plus_one)
    _f32_close(tc.rms_norm(torch.from_numpy(x), torch.from_numpy(w), plus_one=plus_one), want)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jc.rms_norm(xb, jnp.asarray(w), plus_one=plus_one)
    got = tc.rms_norm(_t(xb, "bfloat16"), torch.from_numpy(w), plus_one=plus_one)
    assert got.dtype == torch.bfloat16
    # f32 inside, one rounding to bf16 at the end: at most one bf16 ulp apart
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2**-7, atol=0)
    want = jc.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _f32_close(tc.layer_norm(*map(torch.from_numpy, (x, w, b))), want)
