"""The port's Coefficient Generator under ``test_coeff_gen_props.py``'s sweeps.

JAX's strategies and settings; every example also goes through the JAX
package and must give identical integers: the decay code (k, bypass, the
9-bit register), ``apply_decay``'s shift-add outputs, and the grid.
Self-skips without hypothesis.
"""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property suite needs hypothesis (pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

import torch

from repro.core import coeff_gen as jcg
from repro_torch.core import coeff_gen
from repro_torch.core.coeff_gen import apply_decay, encode_decay, quantization_grid


@given(beta=st.floats(0.0, 1.0), leak_bits=st.integers(1, 8))
@settings(max_examples=200, deadline=None)
def test_factor_error_below_half_grid(beta, leak_bits):
    code = encode_decay(beta, leak_bits)
    step = (1 << (8 - leak_bits)) / 256.0
    assert abs(code.factor - beta) <= step / 2 + 1e-12
    want = jcg.encode_decay(beta, leak_bits)
    assert (code.k, code.bypass, code.leak_bits, code.decay_rate_register) == (
        want.k, want.bypass, want.leak_bits, want.decay_rate_register)


@given(
    k=st.integers(0, 255),
    xs=st.lists(st.integers(-(2**20), 2**20), min_size=1, max_size=32),
)
@settings(max_examples=200, deadline=None)
def test_shift_add_matches_factor_within_tap_count(k, xs):
    code = coeff_gen.DecayCode(k=k, bypass=False, leak_bits=8)
    got = apply_decay(torch.tensor(xs, dtype=torch.int32), code)
    assert got.dtype == torch.int32
    exact = np.asarray(xs, np.float64) * (k / 256.0)
    assert np.all(np.abs(got.numpy().astype(np.int64) - exact) <= bin(k).count("1") + 1e-9)
    want = jcg.apply_decay(jnp.asarray(xs, jnp.int32), jcg.DecayCode(k=k, bypass=False, leak_bits=8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@given(leak_bits=st.integers(1, 8))
@settings(max_examples=20, deadline=None)
def test_grid_is_reachable(leak_bits):
    grid = quantization_grid(leak_bits)
    np.testing.assert_array_equal(grid, jcg.quantization_grid(leak_bits))
    for f in grid:
        code = encode_decay(float(f), leak_bits)
        assert code.factor == pytest.approx(float(f), abs=1e-12)
        assert code.decay_rate_register == jcg.encode_decay(float(f), leak_bits).decay_rate_register
