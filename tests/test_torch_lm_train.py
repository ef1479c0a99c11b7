"""The training half of the port's LM (``models/transformer.py``:
``forward``, ``_chunked_ce``, ``lm_loss``, MoE blocks, ``remat="block"``,
train-mode attention) and the registry's training handles, against JAX on
the CPU at the reduced configs.

Tolerances: f32 compute (``dataclasses.replace(cfg, compute_dtype=f32)``)
-- loss, ``ce`` and ``aux`` within 1e-5 relative, logits within 1e-4 of max
|logit|, gradients within 1e-4 of each leaf's max |g|; bf16 compute (the
configs' default) -- loss within 5 %, as ``test_torch_lm_serve.py`` allows.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro.models.registry import SHAPES as J_SHAPES
from repro.models.registry import get_arch as j_get_arch
from repro.models.registry import list_archs as j_list_archs
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import flash_attend
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.common import params_from_numpy, tree_leaves
from repro_torch.models.registry import SHAPES, ShapeSpec, get_arch, list_archs

ARCHS = ["gemma2-27b", "granite-moe-1b-a400m", "jamba-v0.1-52b", "mamba2-780m", "nemotron-4-15b",
         "phi3-medium-14b", "qwen2-moe-a2.7b", "qwen2-vl-2b", "stablelm-1.6b"]


def _models(name, compute, **overrides):
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg = dataclasses.replace(jarch.reduced_config, compute_dtype=getattr(jnp, compute), **overrides)
    tcfg = dataclasses.replace(tarch.reduced_config, compute_dtype=getattr(torch, compute), **overrides)
    jparams = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(vocab, B=2, S=80, seed=0, cfg=None):
    """Tokens and targets; with an SSM ``cfg``, S rounded up to whole SSD
    chunks (the scan takes whole chunks)."""
    if cfg is not None and cfg.ssm is not None and S > cfg.ssm.chunk:
        S = -(-S // cfg.ssm.chunk) * cfg.ssm.chunk
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32) for k in ("tokens", "targets")}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def test_six_archs_are_ported():
    """The nine decoder-only archs of this file's parametrizations plus
    whisper-medium are the JAX package's ten (the name is from when six
    were; whisper's training is ``tests/test_torch_whisper.py``'s)."""
    assert list_archs() == sorted(ARCHS + ["whisper-medium"]) == sorted(j_list_archs())


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_matches_jax(name, compute):
    """S = 80: MoE chunks of 64 with a ragged last chunk (S = 96 with SSD
    chunks of 32); ce and aux apart."""
    jcfg, tcfg, jp, tp = _models(name, compute)
    b = _batch(jcfg.vocab, cfg=tcfg)
    jl, jm = jt.lm_loss(jcfg, jp, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        tl, tm = tt.lm_loss(tcfg, tp, _t(b))
    tol = 1e-5 if compute == "float32" else 0.05
    assert _rel(tl, jl) <= tol
    assert _rel(tm["ce"], jm["ce"]) <= tol
    if jcfg.moe is None:
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    else:
        assert float(jm["aux"]) > 0 and _rel(tm["aux"], jm["aux"]) <= tol


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match_jax(name):
    jcfg, tcfg, jp, tp = _models(name, "float32")
    toks = _batch(jcfg.vocab, cfg=tcfg)["tokens"]
    jlog, jaux = jt.forward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        tlog, taux = tt.forward(tcfg, tp, torch.from_numpy(toks))
    want = np.asarray(jlog)
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == want.shape
    assert float(np.abs(tlog.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max())
    assert abs(float(taux) - float(jaux)) <= 1e-5 * max(abs(float(jaux)), 1e-30)


def _grads(tcfg, tp, batch):
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(tp)]
    loss, _ = tt.lm_loss(tcfg, tp, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_gradients_match_jax_grad(name):
    jcfg, tcfg, jp, tp = _models(name, "float32")
    b = _batch(jcfg.vocab, S=72, seed=1, cfg=tcfg)
    jg = jax.grad(lambda p: jt.lm_loss(jcfg, p, {k: jnp.asarray(v) for k, v in b.items()})[0])(jp)
    _, tg = _grads(tcfg, tp, _t(b))
    paths = [p for p, _ in tree_leaves(tp)]
    for path, g, w in zip(paths, tg, jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * max(float(np.abs(w).max()), 1e-30), path


@pytest.mark.parametrize("name", ["stablelm-1.6b", "qwen2-moe-a2.7b"])
def test_remat_block_equals_no_remat(name):
    """Recomputing each group in the backward pass gives the same loss and
    gradients, and does recompute (the blocks run twice)."""
    _, tcfg, _, tp = _models(name, "float32")
    b = _t(_batch(tcfg.vocab, S=64, seed=2))
    calls = {"n": 0}
    real = tt._block_apply

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    with mock.patch.object(tt, "_block_apply", counted):
        l0, g0 = _grads(tcfg, tp, b)
        plain = calls["n"]
        l1, g1 = _grads(dataclasses.replace(tcfg, remat="block"), tp, b)
        remat = calls["n"] - plain
    assert plain == tcfg.n_layers and remat == 2 * tcfg.n_layers
    assert float(l0) == float(l1)
    for a, c in zip(g0, g1):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_train_mode_at_4096_tokens_has_a_backward_and_matches_jax():
    """A 1-layer narrow model at S = 4096: train mode runs the plain
    query-chunked attention (JAX's ``attend_chunked``), never the
    forward-only flash route, and its loss and gradients match JAX's."""
    narrow = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=64, vocab=64)
    jcfg, tcfg, jp, tp = _models("stablelm-1.6b", "float32", **narrow)
    b = _batch(64, B=1, S=4096, seed=3)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, {k: jnp.asarray(v) for k, v in b.items()}), has_aux=True
    )(jp)

    def no_flash(*a, **kw):
        raise AssertionError("train mode took the flash route")

    with mock.patch.object(tattn, "attend_chunked", no_flash):
        tl, tg = _grads(tcfg, tp, _t(b))
    assert _rel(tl, jl) <= 1e-5
    for g, w in zip(tg, jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * max(float(np.abs(w).max()), 1e-30)


def test_flash_attention_refuses_inputs_that_require_grad():
    """The kernel has no backward: an input that requires grad raises on
    every device (here its plain version) instead of being detached."""
    q = torch.randn(1, 64, 2, 32, requires_grad=True)
    k, v = torch.randn(1, 64, 2, 32), torch.randn(1, 64, 2, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attend(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(k.transpose(1, 2), q.transpose(1, 2), v.transpose(1, 2))
    with torch.no_grad():
        assert flash_attend(q, k, v).shape == (1, 64, 2, 32)
    assert flash_attend(q.detach(), k, v).shape == (1, 64, 2, 32)


@pytest.mark.parametrize("name", ARCHS)
def test_input_and_cache_templates_match_jax(name):
    t, j = get_arch(name), j_get_arch(name)
    for shape_name, shape in SHAPES.items():
        cfg = t.reduced_config
        got = t.input_template(shape, cfg)
        want = j.input_template(J_SHAPES[shape_name], j.reduced_config)
        assert {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in got.items()} == {
            k: (tuple(v.shape), v.dtype.name) for k, v in want.items()
        }
    small = ShapeSpec("d", 16, 2, "decode")
    got = t.cache_abstract(small, t.reduced_config)
    want = j.cache_abstract(small, j.reduced_config)
    assert {p: {n: s for n, (s, _) in c.items()} for p, c in got.items()} == {
        p: {n: tuple(v.shape) for n, v in c.items()} for p, c in want.items()
    }


def test_input_concrete_from_a_generator():
    arch = get_arch("granite-moe-1b-a400m")
    cfg = arch.reduced_config
    train = ShapeSpec("t", 12, 3, "train")
    a = arch.input_concrete(torch.Generator().manual_seed(4), train, cfg)
    b = arch.input_concrete(torch.Generator().manual_seed(4), train, cfg, device="cpu")
    assert set(a) == {"tokens", "targets"} and a["tokens"].dtype == torch.int32
    assert a["tokens"].shape == (3, 12) and torch.equal(a["targets"], b["targets"])
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < cfg.vocab
    d = arch.input_concrete(torch.Generator().manual_seed(4), ShapeSpec("d", 12, 3, "decode"), cfg)
    assert d["tokens"].shape == (3, 1) and d["cur_len"].tolist() == [6, 6, 6]
