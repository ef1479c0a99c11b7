"""The port's mixture-of-experts (``models/mlp.py``: ``moe_template``,
``_capacity``, ``_route``, ``_moe_chunk``, ``moe_apply``) against JAX's on
the CPU.

Routing is held exactly: the nonzero pattern of the gates equals JAX's,
ties included (``jax.lax.top_k`` keeps the lower expert; the port takes the
top k of a stable descending sort).  Outputs at f32 compute within 1e-4 of
max |out| and the auxiliary loss within 1e-5 relative; at bf16 within 5 %.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as jmlp
from repro.models.registry import get_arch as j_get_arch
from repro_torch.models import mlp as tmlp
from repro_torch.models.common import materialize, params_from_numpy
from repro_torch.models.registry import get_arch

MOE_ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]


def _cfgs(name, **overrides):
    j = dataclasses.replace(j_get_arch(name).reduced_config.moe, **overrides)
    t = dataclasses.replace(get_arch(name).reduced_config.moe, **overrides)
    assert dataclasses.astuple(j) == dataclasses.astuple(t)
    return j, t


def _params(jcfg, seed=0):
    from repro.models.common import materialize as jmat

    jp = jmat(jax.random.PRNGKey(seed), jmlp.moe_template(jcfg))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _shapes(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        out.update(_shapes(v, p) if isinstance(v, dict) else {p: tuple(v.shape)})
    return out


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_template_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    jt, tt = jmlp.moe_template(jcfg), tmlp.moe_template(tcfg)
    assert _shapes(tt) == _shapes(jt)
    flat = lambda t: {p: (s.init, s.scale) for p, s in _flat_specs(t)}
    assert flat(tt) == flat(jt)
    assert ("shared" in tt) == (tcfg.n_shared > 0)
    for chunk in (1, 7, 64, 512):
        assert tmlp._capacity(tcfg, chunk) == jmlp._capacity(jcfg, chunk)
    # materialized from a torch generator: shapes and dtypes of the template
    got = materialize(torch.Generator().manual_seed(0), tt)
    assert _shapes(got) == _shapes(jt)


def _flat_specs(tree, path=""):
    for k in sorted(tree):
        v, p = tree[k], f"{path}/{k}"
        if isinstance(v, dict):
            yield from _flat_specs(v, p)
        else:
            yield p, v


CASES = [
    pytest.param("granite-moe-1b-a400m", 128, {}, id="granite"),
    pytest.param("qwen2-moe-a2.7b", 128, {}, id="qwen2-shared"),
    pytest.param("qwen2-moe-a2.7b", 100, {}, id="qwen2-ragged-last-chunk"),
    pytest.param("granite-moe-1b-a400m", 40, {"seq_chunk": 512}, id="granite-one-short-chunk"),
]


@pytest.mark.parametrize("name,S,overrides", CASES)
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(name, S, overrides, compute):
    jcfg, tcfg = _cfgs(name, **overrides)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(3).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, compute))
    tx = torch.from_numpy(x).to(getattr(torch, compute))
    jout, jaux = jmlp.moe_apply(jcfg, jp, jx)
    tout, taux = tmlp.moe_apply(tcfg, tp, tx)
    assert tout.dtype == tx.dtype and tuple(tout.shape) == jout.shape
    want = np.asarray(jout.astype(jnp.float32))
    got = tout.float().numpy()
    tol = 1e-4 if compute == "float32" else 0.05
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())
    aux_tol = 1e-5 if compute == "float32" else 0.05
    assert abs(float(taux) - float(jaux)) <= aux_tol * abs(float(jaux))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_routing_equals_jax_exactly(name):
    """The same f32 router logits: identical gate pattern (which experts
    every token goes to) and the same gate values to f32 rounding."""
    jcfg, tcfg = _cfgs(name)
    logits = np.random.default_rng(7).standard_normal((3, 64, jcfg.n_experts)).astype(np.float32)
    jg, jaux = jmlp._route(jcfg, jnp.asarray(logits))
    tg, taux = tmlp._route(tcfg, torch.from_numpy(logits))
    np.testing.assert_array_equal(tg.numpy() > 0, np.asarray(jg) > 0)
    assert int((tg > 0).sum(-1).min()) == int((tg > 0).sum(-1).max()) == tcfg.top_k
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_routing_ties_break_toward_the_lower_expert():
    """Rows of equal logits (all tied, tied pairs straddling the k-th place):
    JAX's top_k and the port pick the same, lower, experts."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b")  # 8 experts, top 2
    E = jcfg.n_experts
    rows = np.zeros((1, 5, E), np.float32)  # row 0: all tied
    rows[0, 1] = [0, 1, 1, 1, 0, 0, 1, 0]  # four tied for two places
    rows[0, 2] = [2, 0, 1, 0, 0, 1, 0, 1]  # one clear, three tied for the second
    rows[0, 3] = np.arange(E)[::-1]  # descending: experts 0, 1
    rows[0, 4] = [0, 0, 0, 0, 0, 0, 3, 3]  # the tie at the top, high experts
    jg, _ = jmlp._route(jcfg, jnp.asarray(rows))
    tg, _ = tmlp._route(tcfg, torch.from_numpy(rows))
    picked = [sorted(np.flatnonzero(r).tolist()) for r in tg[0].numpy()]
    assert picked == [sorted(np.flatnonzero(r).tolist()) for r in np.asarray(jg)[0]]
    assert picked == [[0, 1], [1, 2], [0, 2], [0, 1], [6, 7]]


def test_capacity_positions_drop_overflow_tokens_as_jax():
    """Every token routed to expert 0 (one huge router column): only the
    first ``capacity`` tokens of each row keep a dispatch slot."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", top_k=1)
    jp, tp = _params(jcfg)
    jp = dict(jp, router=jp["router"].at[:, 0].set(50.0))
    tp = dict(tp, router=tp["router"].clone())
    tp["router"][:, 0] = 50.0
    x = np.abs(np.random.default_rng(1).standard_normal((2, 64, jcfg.d_model))).astype(np.float32)
    jout, _ = jmlp._moe_chunk(jcfg, jp, jnp.asarray(x))
    tout, _ = tmlp._moe_chunk(tcfg, tp, torch.from_numpy(x))
    cap = tmlp._capacity(tcfg, 64)
    assert cap < 64
    got, want = tout.numpy(), np.asarray(jout)
    assert np.all(got[:, cap:] == 0) and np.all(want[:, cap:] == 0)
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())
