"""The port's LM slice -- configs, ``prefill``, ``decode_step``, ``ServeEngine``
-- against the JAX package at reduced sizes on the CPU.

JAX's default ``qdot`` (no kernel hook) dequantizes a QTensor to the
activation dtype before the matmul, which rounds differently from the
kernel's f32-accumulate-then-scale contract; the port always follows the
kernel.  So every comparison with quantized weights runs JAX with
``repro.kernels.quant_matmul.ops.enable(interpret=True)`` (the Pallas kernel
in interpret mode), and the ``jax_quant_kernel`` fixture disables it again.

Tolerances: at f32 compute both sides do the same f32 arithmetic in other
summation orders, so logits agree to 1e-4 of max |logit| and greedy tokens
are identical.  At bf16 compute a one-ulp rounding difference early in the
stack can grow through the layers, so logits are held to 5 % of max |logit|
and a greedy token only where the top-2 margin is wider than that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jp
from repro.kernels.quant_matmul import ops as j_qm_ops
from repro.models import transformer as jt
from repro.models.registry import get_arch as j_get_arch
from repro.models.registry import list_archs as j_list_archs
from repro.serve import engine as j_engine
from repro_torch.core import precision as tp
from repro_torch.launch import serve as t_launch
from repro_torch.models import transformer as tt
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import SHAPES, get_arch, list_archs
from repro_torch.serve import engine as t_engine

DENSE = ["gemma2-27b", "nemotron-4-15b", "phi3-medium-14b", "stablelm-1.6b"]
# the MoE, SSM, hybrid and VLM families too: the nine decoder-only archs
# (whisper-medium's serving is tests/test_torch_whisper.py's)
PORTED = sorted(DENSE + ["granite-moe-1b-a400m", "qwen2-moe-a2.7b", "mamba2-780m", "jamba-v0.1-52b", "qwen2-vl-2b"])
RULES = t_launch.QUANT_RULES[0]


@pytest.fixture
def jax_quant_kernel():
    j_qm_ops.enable(interpret=True)
    yield
    j_qm_ops.disable()


def _field_value(v):
    if dataclasses.is_dataclass(v):  # MoEConfig, SSMConfig: field by field
        return dataclasses.asdict(v)
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type) or hasattr(v, "dtype"):  # a jnp dtype class
        return jnp.dtype(v).name
    return v


def test_registry_holds_the_four_dense_configs_field_for_field():
    from repro.models.registry import SHAPES as J_SHAPES

    assert list_archs() == sorted(PORTED + ["whisper-medium"]) == sorted(j_list_archs())
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in J_SHAPES.items()
    }
    for name in list_archs():
        t, j = get_arch(name), j_get_arch(name)
        assert (t.name, t.family, t.skip_shapes, t.skip_reason, t.n_vision_tokens) == (
            j.name, j.family, j.skip_shapes, j.skip_reason, j.n_vision_tokens,
        )
        for tcfg, jcfg in [(t.config, j.config), (t.reduced_config, j.reduced_config)]:
            tf = {f.name: _field_value(getattr(tcfg, f.name)) for f in dataclasses.fields(tcfg)}
            jf = {f.name: _field_value(getattr(jcfg, f.name)) for f in dataclasses.fields(jcfg)}
            assert tf == jf, name


@pytest.mark.parametrize("name", PORTED)
def test_model_template_shapes_match_jax(name):
    t, j = get_arch(name), j_get_arch(name)
    got = {}

    def walk(tree, path=""):
        for k, v in tree.items():
            p = f"{path}/{k}"
            walk(v, p) if isinstance(v, dict) else got.__setitem__(p, tuple(v.shape))

    walk(t.template(t.reduced_config))
    want = {
        "/" + "/".join(str(p.key) for p in path): tuple(s.shape)
        for path, s in jax.tree_util.tree_leaves_with_path(j.abstract_params(j.reduced_config))
    }
    assert got == want


def _models(name, compute, quant_bits=None, **overrides):
    """(JAX cfg, port cfg, JAX params, port params) at the reduced size, with
    the port's params carried over from JAX's init."""
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg = dataclasses.replace(jarch.reduced_config, compute_dtype=getattr(jnp, compute), **overrides)
    tcfg = dataclasses.replace(tarch.reduced_config, compute_dtype=getattr(torch, compute), **overrides)
    jparams = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    if quant_bits:
        jparams = jp.quantize_tree(jparams, jp.PrecisionPolicy(rules=((RULES, quant_bits),)))
        tparams = tp.quantize_tree(tparams, tp.PrecisionPolicy(rules=((RULES, quant_bits),)))
    return jcfg, tcfg, jparams, tparams


def _f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def _check_logits(got, want, compute):
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max())
    tol = 1e-4 if compute == "float32" else 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * tol * scale
    if compute == "float32":
        assert decided.all(), "a near-tie in the f32 logits: pick another seed"
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


CASES = [
    ("stablelm-1.6b", "float32", None, {}),
    ("stablelm-1.6b", "float32", 8, {}),
    ("stablelm-1.6b", "float32", 4, {}),
    ("stablelm-1.6b", "float32", 8, {"kv_cache_bits": 8}),
    ("gemma2-27b", "float32", 8, {}),
    ("stablelm-1.6b", "bfloat16", 8, {}),
    ("gemma2-27b", "bfloat16", None, {}),
]


@pytest.mark.parametrize("name,compute,bits,overrides", CASES)
def test_decode_steps_match_jax(jax_quant_kernel, name, compute, bits, overrides):
    """Three decode steps of 2 slots at different lengths against JAX: logits
    each step, greedy tokens, and the caches (written in place in the port)."""
    jcfg, tcfg, jparams, tparams = _models(name, compute, bits, **overrides)
    B, L = 2, 12
    jc = jt.cache_init(jcfg, B, L)
    tc = tt.cache_init(tcfg, B, L, device="cpu")
    cur = np.array([0, 5], np.int32)
    rng = np.random.default_rng(1)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jt.decode_step(jcfg, jparams, jc, jnp.asarray(tok), jnp.asarray(cur))
        tl, tc2 = tt.decode_step(tcfg, tparams, tc, torch.from_numpy(tok).long(), torch.from_numpy(cur))
        assert tc2 is tc  # updated in place
        _check_logits(tl, jl, compute)
        cur = cur + 1
    for pos in jc:
        for name_ in ("k", "v", "len"):
            got, want = _f32(tc[pos][name_]), _f32(jc[pos][name_])
            tol = 0 if name_ == "len" else (1e-5 if compute == "float32" else 0.05)
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize(
    "name,compute,bits,S,overrides",
    [
        ("stablelm-1.6b", "float32", 8, 24, {}),
        ("gemma2-27b", "float32", None, 80, {}),  # past the 64-token local window
        ("gemma2-27b", "float32", 8, 40, {"gqa_flat": True}),  # kv heads repeated before attend
        ("stablelm-1.6b", "bfloat16", 8, 24, {}),
        ("stablelm-1.6b", "float32", 8, 4096, {}),  # attend_chunked: the flash kernel's path on the card
    ],
)
def test_prefill_matches_jax(jax_quant_kernel, name, compute, bits, S, overrides):
    jcfg, tcfg, jparams, tparams = _models(name, compute, bits, **overrides)
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab, (1, S)).astype(np.int32)
    jl, jc = jt.prefill(jcfg, jparams, jnp.asarray(tokens))
    arch = dataclasses.replace(get_arch(name), reduced_config=tcfg)
    tl, tc = arch.prefill_fn(tcfg)(tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert tl.shape == (1, 1, jcfg.vocab)
    _check_logits(tl, jl, compute)
    for pos in jc:
        assert tc[pos]["k"].shape == jc[pos]["k"].shape
        np.testing.assert_array_equal(tc[pos]["len"].numpy(), np.asarray(jc[pos]["len"]))
        tol = 1e-4 if compute == "float32" else 0.05
        for name_ in ("k", "v"):
            want = _f32(jc[pos][name_])
            np.testing.assert_allclose(_f32(tc[pos][name_]), want, rtol=0, atol=tol * np.abs(want).max())


def _serve(engine_mod, arch, params, prompts, max_new, **kw):
    eng = engine_mod.ServeEngine(arch, params, **kw)
    reqs = [engine_mod.Request(uid=i, prompt=np.asarray(p), max_new_tokens=max_new) for i, p in enumerate(prompts)]
    done = eng.run(reqs)
    return eng, {r.uid: list(map(int, r.generated)) for r in done}


@pytest.mark.parametrize(
    "bits,prompts,max_new",
    [
        # tests/test_system.py:125 -- identical prompts through 2 slots, two waves
        (None, [[3, 17, 29]] * 4, 5),
        # tests/test_system.py:144 -- int8 weights
        (8, [[5, 11]], 4),
        # ragged prompts, continuous batching with slots freed at different ticks
        (8, [[1, 2, 3, 4, 5, 6], [7], [8, 9, 10], [3, 17, 29], [11, 12], [1, 2, 3, 4, 5, 6]], 6),
        (4, [[9, 8, 7], [6], [5, 4]], 5),
    ],
)
def test_serve_engine_matches_jax(jax_quant_kernel, bits, prompts, max_new):
    """f32 compute: identical generated tokens, request by request, and
    identical prompts give identical tokens whichever slot and wave served them."""
    jcfg, tcfg, jparams, tparams = _models("stablelm-1.6b", "float32")
    jarch = dataclasses.replace(j_get_arch("stablelm-1.6b"), reduced_config=jcfg)
    tarch = dataclasses.replace(get_arch("stablelm-1.6b"), reduced_config=tcfg)
    jq = jp.PrecisionPolicy(rules=((RULES, bits),)) if bits else None
    tq = tp.PrecisionPolicy(rules=((RULES, bits),)) if bits else None
    _, want = _serve(j_engine, jarch, jparams, prompts, max_new, max_batch=2, max_len=64, quant=jq)
    eng, got = _serve(
        t_engine, tarch, tparams, prompts, max_new, max_batch=2, max_len=64, quant=tq, device="cpu"
    )
    assert got == want
    assert all(len(g) == max_new for g in got.values())
    by_prompt = {}
    for p, g in zip(prompts, (got[i] for i in range(len(prompts)))):
        by_prompt.setdefault(tuple(p), set()).add(tuple(g))
    assert all(len(gens) == 1 for gens in by_prompt.values())
    assert eng.decode_steps >= sum(map(len, prompts))


def test_serve_engine_admission_never_perturbs_other_slots():
    """Admitting a request leaves every other slot's cache column and length
    bit for bit as it was."""
    _, tcfg, _, tparams = _models("stablelm-1.6b", "float32", 8)
    arch = dataclasses.replace(get_arch("stablelm-1.6b"), reduced_config=tcfg)
    eng = t_engine.ServeEngine(arch, tparams, max_batch=3, max_len=32, device="cpu")
    assert eng.admit(t_engine.Request(uid=0, prompt=np.array([4, 5, 6])))
    eng.tick()
    before = {p: {k: v.clone() for k, v in c.items()} for p, c in eng.caches.items()}
    len_before = eng.cur_len.copy()
    assert eng.admit(t_engine.Request(uid=1, prompt=np.array([7, 8, 9, 10])))
    for p, c in eng.caches.items():
        for k, v in c.items():
            torch.testing.assert_close(v[:, [0, 2]], before[p][k][:, [0, 2]], rtol=0, atol=0)
    assert eng.cur_len[0] == len_before[0] and eng.cur_len[1] == 4


def test_launch_serve_runs_on_cpu_and_refuses_a_missing_card(capsys):
    t_launch.main(["--arch", "stablelm-1.6b", "--requests", "2", "--max-new", "3", "--quant-bits", "8", "--device", "cpu"])
    assert "served 2 requests / 6 tokens" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            t_launch.main(["--arch", "stablelm-1.6b", "--requests", "1"])


@pytest.mark.parametrize("fn", ["params_from_numpy", "cache_init"])
def test_lm_carriers_default_to_the_card(fn):
    """``params_from_numpy`` and ``cache_init`` default to ``cuda`` like every
    entry point: without a card the default raises instead of landing on
    the CPU."""
    cfg = get_arch("stablelm-1.6b").config
    call = {
        "params_from_numpy": lambda **kw: params_from_numpy({"w": {"k": np.ones((2, 2), np.float32)}}, **kw),
        "cache_init": lambda **kw: tt.cache_init(cfg, 1, 4, **kw),
    }[fn]
    leaves = lambda tree: [t for c in tree.values() for t in c.values()]
    assert all(t.device.type == "cpu" for t in leaves(call(device="cpu")))
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in leaves(call()))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
