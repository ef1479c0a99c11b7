"""The port's int4 packing and weight quantization under
``test_kernels_props.py``'s sweeps.

JAX's strategies and settings; every example also goes through the JAX
package and must give identical integers: ``pack_int4`` / ``unpack_int4``,
and ``quantize_weight``'s ints and scales on weights drawn by
``jax.random``.  Self-skips without hypothesis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property suite needs hypothesis (pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

import torch

from repro.core import precision as jprec
from repro_torch.core.precision import dequantize_weight, pack_int4, quantize_weight, unpack_int4


@given(st.lists(st.integers(-8, 7), min_size=2, max_size=64).filter(lambda l: len(l) % 2 == 0))
@settings(max_examples=100, deadline=None)
def test_int4_pack_roundtrip(values):
    v = torch.tensor(values, dtype=torch.int8).reshape(1, -1)
    packed = pack_int4(v)
    np.testing.assert_array_equal(unpack_int4(packed).numpy(), v.numpy())
    jv = jnp.asarray(values, jnp.int8).reshape(1, -1)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jprec.pack_int4(jv)))
    np.testing.assert_array_equal(unpack_int4(packed).numpy(),
                                  np.asarray(jprec.unpack_int4(jprec.pack_int4(jv))))


@given(bits=st.integers(4, 8), seed=st.integers(0, 1000))
@settings(max_examples=30, deadline=None)
def test_quantize_weight_error_bound(bits, seed):
    w = jax.random.normal(jax.random.PRNGKey(seed), (32, 16), jnp.float32)
    qt = quantize_weight(torch.from_numpy(np.array(w)), bits)
    back = dequantize_weight(qt, torch.float32).numpy()
    err = np.abs(back - np.asarray(w))
    assert np.all(err <= qt.scale.numpy()[None, :] * 0.5 + 1e-7)
    want = jprec.quantize_weight(w, bits)
    assert (qt.bits, tuple(qt.shape)) == (want.bits, tuple(want.shape))
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(want.scale))
