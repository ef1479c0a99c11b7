"""Serving-precision paths of the port against ``test_precision_paths.py``.

The cases ``test_torch_lm_serve.py`` does not already hold (it has the
stablelm f32 int8-KV decode against JAX): gemma2's int8 KV cache against its
bf16 cache, on the port and against JAX's same run; the quantized decode of
the whole qwen2-moe stack; and the megatron expert template's logical specs
against JAX's (``test_torch_sharding.py`` holds the archs' default expert
layouts, not this one).  Parameters are JAX's init, carried through numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro.kernels.quant_matmul import ops as j_qm_ops
from repro.models import mlp as jmlp
from repro.models import transformer as jtfm
from repro.models.registry import get_arch as j_get_arch
from repro_torch.core.precision import PrecisionPolicy, quantize_tree
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as tfm
from repro_torch.models.common import params_from_numpy, tree_leaves
from repro_torch.models.registry import get_arch


def _carried(name, **overrides):
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg = dataclasses.replace(jarch.reduced_config, **overrides)
    tcfg = dataclasses.replace(tarch.reduced_config, **overrides)
    jparams = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _decode4(cfg, params, caches, decode, tok, as_tok):
    logits, cur = None, np.zeros((2,), np.int32)
    for t in range(4):  # a few steps so quantization error accumulates
        logits, caches = decode(cfg, params, caches, as_tok(tok + t), cur)
        cur = cur + 1
    return logits


@pytest.mark.parametrize("arch_name", ["gemma2-27b"])
def test_int8_kv_cache_close_to_bf16(arch_name):
    """JAX's case on the port, and each cache's logits against JAX's run of
    the same cache (the bf16 compute's 5 % of max |logit|, as
    ``test_torch_lm_serve.py`` holds bf16 decode)."""
    _, cfg8, jparams, params = _carried(arch_name, kv_cache_bits=8)
    jcfg, cfg, _, _ = _carried(arch_name, kv_cache_bits=None)
    jcfg8 = dataclasses.replace(jcfg, kv_cache_bits=8)
    tok = np.asarray([[3], [5]], np.int32)
    port_dec = lambda c, p, k, t, cur: tfm.decode_step(c, p, k, t, torch.from_numpy(cur))
    jax_dec = lambda c, p, k, t, cur: jtfm.decode_step(c, p, k, t, jnp.asarray(cur))
    to_t = lambda a: torch.from_numpy(a).long()

    l8 = _decode4(cfg8, params, tfm.cache_init(cfg8, 2, 32, device="cpu"), port_dec, tok, to_t)
    lb = _decode4(cfg, params, tfm.cache_init(cfg, 2, 32, device="cpu"), port_dec, tok, to_t)
    assert tree_leaves(tfm.cache_init(cfg8, 2, 32, device="cpu"))[0][1].dtype == torch.int8
    l8, lb = l8.float().numpy(), lb.float().numpy()
    d = float(np.abs(l8 - lb).max())
    assert np.isfinite(d) and d < 0.5, d
    np.testing.assert_array_equal(l8.argmax(-1), lb.argmax(-1))

    for jc, tl in ((jcfg8, l8), (jcfg, lb)):
        jl = _decode4(jc, jparams, jtfm.cache_init(jc, 2, 32), jax_dec, tok, jnp.asarray)
        jl = np.asarray(jl, np.float32)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=0.05 * float(np.abs(jl).max()))


def test_quantized_decode_runs_whole_stack():
    """qwen2-moe's int8 stack (attention, experts, shared expert) decodes to
    finite logits, within the f32 compute's 1e-4 of max |logit| of JAX's
    (JAX with its quant kernel in interpret mode, the port's contract)."""
    rules = PrecisionPolicy(rules=((r"(wq|wk|wv|wo|w_gate|w_up|w_down)$", 8),))
    jcfg, cfg, jparams, params = _carried("qwen2-moe-a2.7b", compute_dtype=jnp.float32)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    qp = quantize_tree(params, rules)
    logits, _ = tfm.decode_step(cfg, qp, tfm.cache_init(cfg, 2, 32, device="cpu"),
                                torch.tensor([[1], [2]]), torch.zeros((2,), dtype=torch.int32))
    got = logits.float().numpy()
    assert np.all(np.isfinite(got))
    j_qm_ops.enable(interpret=True)
    try:
        jq = jprec.quantize_tree(jparams, jprec.PrecisionPolicy(rules=rules.rules))
        want, _ = jtfm.decode_step(jcfg, jq, jtfm.cache_init(jcfg, 2, 32),
                                   jnp.asarray([[1], [2]]), jnp.zeros((2,), jnp.int32))
    finally:
        j_qm_ops.disable()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


def test_megatron_expert_sharding_template_specs():
    """megatron EP: expert axis replicated, FFN dim TP-sharded; each leaf's
    logical axes equal to JAX's template's, for both layouts."""
    kw = dict(d_model=64, d_ff_expert=32, n_experts=8, top_k=2)
    t = tmlp.moe_template(tmlp.MoEConfig(**kw, shard_experts="megatron"))
    assert t["w_gate"].logical == (None, None, "tp")
    assert t["w_down"].logical == (None, "tp", None)
    t2 = tmlp.moe_template(tmlp.MoEConfig(**kw))
    assert t2["w_gate"].logical == ("tp", "fsdp", None)
    for layout in ("megatron", None):
        extra = {"shard_experts": layout} if layout else {}
        got = tmlp.moe_template(tmlp.MoEConfig(**kw, **extra))
        want = jmlp.moe_template(jmlp.MoEConfig(**kw, **extra))
        assert {k: v.logical for k, v in got.items() if hasattr(v, "logical")} == {
            k: v.logical for k, v in want.items() if hasattr(v, "logical")
        }
