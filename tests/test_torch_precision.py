"""The port's precision machinery against the JAX package.

Packing, per-column quantization and policies over stacked parameter trees
are integer / IEEE-f32 operations in the same order on both sides, so they
are held to exact (bitwise) equality.  ``qdot`` on a plain weight is an f32
matmul whose summation order differs between XLA and PyTorch, so it is held
to f32 rounding noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jp
from repro.models.registry import get_arch as j_get_arch
from repro_torch.core import precision as tp
from repro_torch.launch.serve import QUANT_RULES
from repro_torch.models.common import params_from_numpy


def _bits_equal(a_torch, b):
    a = a_torch.cpu().numpy()
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("shape", [(7, 16), (3, 2, 64)])
def test_pack_unpack_int4_bit_equal(shape):
    v = np.random.default_rng(sum(shape)).integers(-8, 8, shape).astype(np.int8)
    packed = tp.pack_int4(torch.from_numpy(v))
    _bits_equal(packed, jp.pack_int4(jnp.asarray(v)))
    _bits_equal(tp.unpack_int4(packed), jp.unpack_int4(jnp.asarray(packed.numpy())))
    np.testing.assert_array_equal(tp.unpack_int4(packed).numpy(), v)


@pytest.mark.parametrize("bits", [4, 5, 6, 7, 8])
@pytest.mark.parametrize("shape,std", [((64, 32), 0.02), ((256, 130), 1.0), ((33, 18), 30.0)])
def test_quantize_weight_bit_equal(bits, shape, std):
    w = (np.random.default_rng(bits).standard_normal(shape) * std).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column: scale is exactly 1e-12
    a = tp.quantize_weight(torch.from_numpy(w), bits)
    b = jp.quantize_weight(jnp.asarray(w), bits)
    assert (a.bits, a.shape) == (b.bits, b.shape)
    _bits_equal(a.q, b.q)
    _bits_equal(a.scale, b.scale)
    for dtype, jdtype in [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]:
        got = tp.dequantize_weight(a, dtype).to(torch.float32).numpy()
        want = np.asarray(jp.dequantize_weight(b, jdtype), np.float32)
        np.testing.assert_array_equal(got, want)


def test_quantize_weight_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        tp.quantize_weight(torch.zeros(4, 4), 3)
    with pytest.raises(ValueError):
        tp.quantize_weight(torch.zeros(4, 5), 4)
    with pytest.raises(ValueError):
        tp.quantize_weight(torch.zeros(2, 4, 4), 8)


@pytest.mark.parametrize("arch_name,bits", [("stablelm-1.6b", 8), ("stablelm-1.6b", 4), ("gemma2-27b", 6)])
def test_quantize_tree_of_stacked_params_bit_equal(arch_name, bits):
    arch = j_get_arch(arch_name)
    jparams = arch.init_params(jax.random.PRNGKey(3), arch.reduced_config)
    policy_j = jp.PrecisionPolicy(rules=((QUANT_RULES[0], bits),))
    policy_t = tp.PrecisionPolicy(rules=((QUANT_RULES[0], bits),))
    want = jax.tree.map(np.asarray, jp.quantize_tree(jparams, policy_j))
    got = tp.quantize_tree(params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"), policy_t)

    n_quantized = 0

    def walk(g, w):
        nonlocal n_quantized
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                walk(g[k], w[k])
        elif isinstance(w, jp.QTensor):
            assert isinstance(g, tp.QTensor) and (g.bits, g.shape) == (w.bits, w.shape)
            _bits_equal(g.q, w.q)
            _bits_equal(g.scale, w.scale)
            for i in range(w.shape[0]):  # one layer group's slice
                layer = g.layer(i)
                assert layer.shape == w.shape[1:]
                _bits_equal(layer.q, w.q[i])
            n_quantized += 1
        else:
            _bits_equal(g, w)

    walk(got, want)
    assert n_quantized == 7 * len(got["blocks"])


def test_policy_first_match_wins_like_jax():
    rules = ((r"mlp/.*", 4), (r"attn/w[qk]$", 8), (r".*", None))
    paths = ["blocks/pos0/mlp/w_up", "blocks/pos0/attn/wq", "blocks/pos0/attn/wv", "embed"]
    got = [tp.PrecisionPolicy(rules).bits_for(p) for p in paths]
    assert got == [jp.PrecisionPolicy(rules).bits_for(p) for p in paths] == [4, 8, None, None]


def test_qdot_plain_weight_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    got = tp.qdot(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jp.qdot(jnp.asarray(x), jnp.asarray(w)))
    # f32 sums of 64 terms in another order: a few ulps of the largest output
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_qdot_on_a_qtensor_runs_the_quant_matmul_wrapper():
    from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul

    w = tp.quantize_weight(torch.randn(32, 16, generator=torch.Generator().manual_seed(0)), 8)
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(1), dtype=torch.float32)
    before = quant_matmul.launches
    y = tp.qdot(x, w)
    assert quant_matmul.launches == before  # the CPU takes the plain version: no launch
    want = (x @ w.q.float()) * w.scale
    torch.testing.assert_close(y, want, rtol=0, atol=1e-5)
    stacked = dataclasses.replace(w, q=w.q[None], scale=w.scale[None], shape=(1, 32, 16))
    with pytest.raises(ValueError):
        tp.qdot(x, stacked)
