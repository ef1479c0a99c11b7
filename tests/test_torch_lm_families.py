"""The SSM, hybrid and VLM families of the port's LM -- mamba2-780m,
jamba-v0.1-52b and qwen2-vl-2b at their reduced configs -- against the JAX
package on the CPU: the VLM's loss, logits and gradients with patch
embeddings and M-RoPE positions, prefill logits and every cache leaf (KV
and SSM), decode steps written in place, ``ServeEngine`` tokens, and
``build_train_step`` steps from carried state.  (``lm_loss``, logits and
gradients of the three configs on token inputs, their templates and their
input templates are the nine-arch parametrizations of
``test_torch_lm_train.py`` and ``test_torch_lm_serve.py``.)

Tolerances, as in ``test_torch_lm_serve.py`` / ``test_torch_lm_train.py``:
at f32 compute logits within 1e-4 of max |logit| with equal greedy tokens,
cache leaves within 1e-4 of each leaf's max |value| (an SSM state sums a
whole prefix), the loss within 1e-5 relative and gradients within 1e-4 of
each leaf's max |g|.  At bf16 compute logits within 5 % of max |logit| --
or, where JAX's own bf16 run lies further than that from its f32 run on the
same parameters, that distance (jamba's 8 reduced layers with MoE: JAX's
bf16 logits lie 15 % of max |logit| from its f32 logits, the port's 13 %,
the two 5 % apart; ``scripts/lm_bf16_drift.py``).  A bf16 cache leaf is held in RMS, relative to the leaf's RMS, to
5 % or twice JAX's own bf16-vs-f32 RMS distance, whichever is larger: two
bf16 runs that each lie d from the f32 values lie at most 2d apart, and an
SSM state's max |difference| over thousands of elements is a heavy tail
of that rounding noise.  Quantized
comparisons run JAX with ``repro.kernels.quant_matmul.ops.enable(interpret=True)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jp
from repro.data.tokens import SyntheticTokens as JTokens
from repro.kernels.quant_matmul import ops as j_qm_ops
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import transformer as jt
from repro.models.registry import ShapeSpec as JShape
from repro.models.registry import get_arch as j_get_arch
from repro.serve import engine as j_engine
from repro.train import optimizer as jopt
from repro_torch.core import precision as tp
from repro_torch.launch import serve as t_launch
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tt
from repro_torch.models.common import params_from_numpy, tree_leaves
from repro_torch.models.registry import ShapeSpec, get_arch
from repro_torch.serve import engine as t_engine
from repro_torch.train import optimizer as topt

FAMILIES = ["mamba2-780m", "jamba-v0.1-52b", "qwen2-vl-2b"]
RULES = t_launch.QUANT_RULES[0]


@pytest.fixture
def jax_quant_kernel():
    j_qm_ops.enable(interpret=True)
    yield
    j_qm_ops.disable()


def _models(name, compute, quant_bits=None, **overrides):
    """(JAX cfg, port cfg, JAX params, port params) at the reduced size, the
    port's carried over from JAX's init."""
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


def _tol(want, want_f32=None):
    """1e-4 at f32 compute; at bf16 (``want_f32`` given: JAX's f32 run of
    the same call) 5 %, or JAX's own bf16-vs-f32 distance where larger."""
    if want_f32 is None:
        return 1e-4
    want, want_f32 = _f32(want), _f32(want_f32)
    return max(0.05, float(np.abs(want - want_f32).max()) / max(float(np.abs(want_f32).max()), 1e-30))


def _check_logits(got, want, want_f32=None):
    tol = _tol(want, want_f32)
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * tol * scale
    if want_f32 is None:
        assert decided.all(), "a near-tie in the f32 logits: pick another seed"
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


def _rms_rel(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / max(float(np.mean(b**2)), 1e-30)))


def _check_caches(got, want, want_f32=None):
    """Every leaf of every pattern position: KV, lengths, SSM conv / state."""
    assert sorted(got) == sorted(want)
    for pos in want:
        assert sorted(got[pos]) == sorted(want[pos]), pos
        for name, w in want[pos].items():
            g = got[pos][name]
            assert tuple(g.shape) == tuple(w.shape) and str(g.dtype).removeprefix("torch.") == w.dtype.name
            g, w = _f32(g), _f32(w)
            if name == "len":
                np.testing.assert_array_equal(g, w)
            elif want_f32 is None:
                atol = 1e-4 * max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{pos}/{name}")
            else:
                limit = max(0.05, 2 * _rms_rel(w, _f32(want_f32[pos][name])))
                assert _rms_rel(g, w) <= limit, (pos, name, _rms_rel(g, w), limit)


def _f32_twin(jcfg):
    """The f32-compute config beside a bf16 one (None at f32 compute)."""
    return None if jcfg.compute_dtype == jnp.float32 else dataclasses.replace(jcfg, compute_dtype=jnp.float32)


def grid_positions3(B: int, n_vis: int, S: int) -> np.ndarray:
    """Qwen2-VL's M-RoPE positions [3, B, S] for a square patch grid then
    text: patch (r, c) at (t, h, w) = (0, r, c); the text continues from the
    largest position + 1 on all three components."""
    side = int(round(n_vis**0.5))
    assert side * side == n_vis
    r, c = np.divmod(np.arange(n_vis), side)
    vis = np.stack([np.zeros(n_vis, np.int64), r, c])
    text = np.broadcast_to(side + np.arange(S - n_vis), (3, S - n_vis))
    return np.broadcast_to(np.concatenate([vis, text], axis=1)[:, None], (3, B, S)).astype(np.int32).copy()


def _vlm_inputs(cfg, B, n_vis, n_text, seed, pos3):
    rng = np.random.default_rng(seed)
    inputs = {
        "tokens": rng.integers(0, cfg.vocab, (B, n_text)).astype(np.int32),
        "vision_embeds": rng.standard_normal((B, n_vis, cfg.d_model)).astype(np.float32),
    }
    if pos3:
        inputs["positions3"] = grid_positions3(B, n_vis, n_vis + n_text)
    return inputs


def _jx(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _tx(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


@pytest.mark.parametrize("pos3", [False, True], ids=["default-positions", "patch-grid"])
def test_vlm_loss_logits_and_gradients_match_jax(pos3):
    """qwen2-vl with 16 patch embeddings before 24 text tokens: the loss
    over the text tail (ce), the logits of ``forward`` over all 40
    positions, and the gradients of every leaf; the positions either the
    default arange or a 4 x 4 patch grid (which must change the loss)."""
    jcfg, tcfg, jparams, tparams = _models("qwen2-vl-2b", "float32")
    inp = _vlm_inputs(jcfg, 2, 16, 24, seed=1, pos3=pos3)
    inp["targets"] = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    jb, tb = _jx(inp), _tx(inp)
    (jl, jm), jg = jax.value_and_grad(lambda p: jt.lm_loss(jcfg, p, jb), has_aux=True)(jparams)
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(tparams)]
    tl, tm = tt.lm_loss(tcfg, tparams, tb)
    tg = torch.autograd.grad(tl, leaves)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(tm["ce"]) - float(jm["ce"])) <= 1e-5 * abs(float(jm["ce"]))
    for (path, _), g, w in zip(tree_leaves(tparams), tg, jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * max(float(np.abs(w).max()), 1e-30), path
    kw = dict(vision_embeds=jb["vision_embeds"], pos3=jb.get("positions3"))
    jlog, _ = jt.forward(jcfg, jparams, jb["tokens"], **kw)
    with torch.no_grad():
        tlog, _ = tt.forward(tcfg, tparams, tb["tokens"], vision_embeds=tb["vision_embeds"],
                             pos3=tb.get("positions3"))
    assert tlog.shape == (2, 40, jcfg.vocab)
    want = np.asarray(jlog)
    assert float(np.abs(tlog.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max())
    if pos3:
        with torch.no_grad():
            plain, _ = tt.lm_loss(tcfg, tparams, {k: v for k, v in tb.items() if k != "positions3"})
        assert abs(float(plain) - float(tl)) > 1e-4 * abs(float(tl))


PREFILL = [
    ("mamba2-780m", "float32", None, 64),  # two SSD chunks: the inter-chunk recurrence
    ("mamba2-780m", "float32", 8, 96),
    ("mamba2-780m", "bfloat16", 8, 64),
    ("jamba-v0.1-52b", "float32", 8, 64),
    ("jamba-v0.1-52b", "bfloat16", None, 96),
    ("qwen2-vl-2b", "float32", 8, 48),
    ("qwen2-vl-2b", "bfloat16", 8, 48),
]


@pytest.mark.parametrize("name,compute,bits,S", PREFILL)
def test_prefill_logits_and_every_cache_leaf_match_jax(jax_quant_kernel, name, compute, bits, S):
    """Through the registry's ``prefill_fn``; the VLM gets 16 patch
    embeddings on a 4 x 4 grid before S - 16 text tokens."""
    jcfg, tcfg, jparams, tparams = _models(name, compute, bits)
    if name == "qwen2-vl-2b":
        inp = _vlm_inputs(jcfg, 1, 16, S - 16, seed=S, pos3=True)
    else:
        inp = {"tokens": np.random.default_rng(S).integers(0, jcfg.vocab, (1, S)).astype(np.int32)}
    jarch = dataclasses.replace(j_get_arch(name), reduced_config=jcfg)
    tarch = dataclasses.replace(get_arch(name), reduced_config=tcfg)
    jl, jc = jarch.prefill_fn(jcfg)(jparams, _jx(inp))
    with torch.no_grad():
        tl, tc = tarch.prefill_fn(tcfg)(tparams, _tx(inp))
    assert tl.shape == (1, 1, jcfg.vocab)
    twin = _f32_twin(jcfg)
    jl32, jc32 = (None, None) if twin is None else jarch.prefill_fn(twin)(jparams, _jx(inp))
    _check_logits(tl, jl, jl32)
    _check_caches(tc, jc, jc32)


DECODE = [
    ("mamba2-780m", "float32", None),
    ("mamba2-780m", "float32", 8),
    ("mamba2-780m", "float32", 4),
    ("jamba-v0.1-52b", "float32", 8),
    ("jamba-v0.1-52b", "float32", 8, {"kv_cache_bits": 8}),
    ("qwen2-vl-2b", "float32", 8),
    ("jamba-v0.1-52b", "bfloat16", 8),
    ("qwen2-vl-2b", "bfloat16", None),
]


@pytest.mark.parametrize("case", DECODE, ids=lambda c: "-".join(str(x) for x in c[:3]))
def test_decode_steps_match_jax(jax_quant_kernel, case):
    """Three decode steps of 2 slots at different lengths: logits each step,
    greedy tokens, and every cache leaf -- K/V and the SSM conv / state --
    updated in place in the port (the caller's caches come back)."""
    name, compute, bits, *rest = case
    jcfg, tcfg, jparams, tparams = _models(name, compute, bits, **(rest[0] if rest else {}))
    B, L = 2, 12
    twin = _f32_twin(jcfg)
    jc = jt.cache_init(jcfg, B, L)
    jc32 = None if twin is None else jt.cache_init(twin, B, L)
    tc = tt.cache_init(tcfg, B, L, device="cpu")
    ssm_leaf = next((c["state"] for c in tc.values() if "state" in c), None)
    cur = np.array([0, 5], np.int32)
    rng = np.random.default_rng(1)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jt.decode_step(jcfg, jparams, jc, jnp.asarray(tok), jnp.asarray(cur))
        jl32 = None
        if twin is not None:
            jl32, jc32 = jt.decode_step(twin, jparams, jc32, jnp.asarray(tok), jnp.asarray(cur))
        tl, tc2 = tt.decode_step(tcfg, tparams, tc, torch.from_numpy(tok).long(), torch.from_numpy(cur))
        assert tc2 is tc
        _check_logits(tl, jl, jl32)
        cur = cur + 1
    if ssm_leaf is not None:  # the preallocated SSM leaves were written where they lie
        assert ssm_leaf.abs().max() > 0 and next(c["state"] for c in tc.values() if "state" in c) is ssm_leaf
    _check_caches(tc, jc, jc32)


@pytest.mark.parametrize("name", ["mamba2-780m", "jamba-v0.1-52b"])
def test_prefill_then_decode_continues_the_sequence(name):
    """A prefill's caches carried into fresh decode buffers, then 4 decode
    steps, give the logits of one longer prefill at every step (f32, int8).
    jamba's MoE gets room for every token (capacity factor = experts /
    top k), since capacity drops differ between a prefill and a decode."""
    moe = get_arch(name).reduced_config.moe
    over = {} if moe is None else {"moe": dataclasses.replace(moe, capacity_factor=moe.n_experts / moe.top_k)}
    _, tcfg, _, tparams = _models(name, "float32", 8, **over)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab, (1, 36)))
    with torch.no_grad():
        _, caches = tt.prefill(tcfg, tparams, tokens[:, :32])
        buf = tt.cache_init(tcfg, 1, 40, device="cpu")
        for pos, c in caches.items():
            for name_, t in c.items():
                if name_ in ("k", "v"):
                    buf[pos][name_][:, :, :32] = t
                else:
                    buf[pos][name_].copy_(t)
        for i in range(32, 36):
            got, _ = tt.decode_step(tcfg, tparams, buf, tokens[:, i : i + 1], torch.tensor([i], dtype=torch.int32))
            want, _ = tt.prefill(dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk=i + 1)),
                                 tparams, tokens[:, : i + 1])
            _check_logits(got, want)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_engine_int8_tokens_match_jax(jax_quant_kernel, name):
    """f32 compute, int8 block weights, ragged prompts through 2 slots in
    two waves: identical generated tokens request by request; the repeated
    prompt gives the same tokens in another slot and wave (the SSM state
    of a freed slot is zeroed on admission)."""
    jcfg, tcfg, jparams, tparams = _models(name, "float32")
    jarch = dataclasses.replace(j_get_arch(name), reduced_config=jcfg)
    tarch = dataclasses.replace(get_arch(name), reduced_config=tcfg)
    prompts = [[3, 17, 29, 4], [7], [8, 9, 10], [3, 17, 29, 4]]
    kw = dict(max_batch=2, max_len=32)
    jq, tq = jp.PrecisionPolicy(rules=((RULES, 8),)), tp.PrecisionPolicy(rules=((RULES, 8),))

    def serve(mod, arch, params, **extra):
        eng = mod.ServeEngine(arch, params, **kw, **extra)
        reqs = [mod.Request(uid=i, prompt=np.asarray(p), max_new_tokens=5) for i, p in enumerate(prompts)]
        return {r.uid: list(map(int, r.generated)) for r in eng.run(reqs)}

    want = serve(j_engine, jarch, jparams, quant=jq)
    got = serve(t_engine, tarch, tparams, quant=tq, device="cpu")
    assert got == want
    assert got[0] == got[3] and all(len(g) == 5 for g in got.values())


SEQ, BATCH, STEPS = 32, 2, 3


def _train_batches(name, jcfg, n):
    data = JTokens(vocab=jcfg.vocab, seq_len=SEQ, batch=BATCH, seed=5)
    out = []
    for i in range(n):
        b = next(data)
        if name == "qwen2-vl-2b":  # the input template's split: 16 patches + 16 text tokens
            inp = _vlm_inputs(jcfg, BATCH, 16, 16, seed=10 + i, pos3=True)
            b = dict(tokens=b["tokens"][:, :16], targets=b["targets"][:, :16],
                     vision_embeds=inp["vision_embeds"], positions3=inp["positions3"])
        out.append(b)
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_train_steps_match_jax_from_carried_state(name):
    """One JAX step first (nonzero moments, step 1), then 3 steps on each
    side from the carried state: every loss, ce, aux and gradient norm
    within 1e-5, the moments and the parameters within 1e-3 of each leaf's
    max (``test_torch_lm_train_step.py``'s limits).  Parameters are held
    where AdamW's update is conditioned, sqrt(nu_hat) > 100 eps or no
    gradient ever (weight decay alone): where the
    gradient is rounding noise near eps (qwen2-vl's key bias along the
    slowest rotary frequencies, which softmax barely sees), g / (|g| + eps)
    turns float reordering into updates of either sign (ROADMAP Queue 3)."""
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg = dataclasses.replace(jarch.reduced_config, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tarch.reduced_config, compute_dtype=torch.float32)
    shape = JShape("t", SEQ, BATCH, "train")
    jstep = jsteps.build_train_step(jarch, shape, j_host_mesh(), jcfg).jitted
    params = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    state = jopt.adamw(3e-4).init(params)
    batches = _train_batches(name, jcfg, STEPS + 1)
    if name == "qwen2-vl-2b":
        want = {k: (tuple(v.shape), v.dtype.name) for k, v in jarch.input_template(shape, jcfg).items()}
        assert {k: (v.shape, v.dtype.name) for k, v in batches[0].items()} == {
            k: (s, "float32" if d == "bfloat16" else d) for k, (s, d) in want.items()
        }
        batches = [{k: (v.astype(jnp.bfloat16) if k == "vision_embeds" else v) for k, v in b.items()}
                   for b in batches]
    params, state, _ = jstep(params, state, batches[0])
    host = lambda tree: jax.tree.map(np.asarray, tree)
    tparams = params_from_numpy(host(params), device="cpu")
    tstate = topt.adamw_state_from_numpy(host(state), device="cpu")
    tstep = tsteps.build_train_step(tarch, ShapeSpec("t", SEQ, BATCH, "train"), None, tcfg).jitted
    for b in batches[1:]:
        params, state, jm = jstep(params, state, b)
        tb = {k: (torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16) if k == "vision_embeds"
                  else torch.from_numpy(np.asarray(v))) for k, v in b.items()}
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1e-6), k
    bias_c = 1 - 0.999 ** int(state.step)  # adamw's b2
    for (path, t), w, nu in zip(tree_leaves(tparams), jax.tree.leaves(params), jax.tree.leaves(state.nu)):
        w = np.asarray(w)
        nu = np.asarray(nu)
        held = (nu == 0) | (np.sqrt(nu / bias_c) > 100 * 1e-8)  # nu == 0: weight decay alone
        assert held.any(), path
        err = np.abs(t.numpy() - w)[held]
        assert float(err.max()) <= 1e-3 * float(np.abs(w).max()), path
    back = topt.adamw_state_to_numpy(tstate, tparams)
    for ours, theirs in [(back["mu"], state.mu), (back["nu"], state.nu)]:
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
            b = np.asarray(b)
            assert float(np.abs(a - b).max()) <= 1e-3 * max(float(np.abs(b).max()), 1e-30)


def test_vlm_inputs_from_the_registry():
    """``input_concrete`` follows ``input_template``: 256 patches cap at
    half the sequence, bf16 embeddings drawn from the generator, and the
    prefill function takes them with the positions."""
    arch = get_arch("qwen2-vl-2b")
    cfg = dataclasses.replace(arch.reduced_config, compute_dtype=torch.float32)
    shape = ShapeSpec("p", 32, 2, "prefill")
    a = arch.input_concrete(torch.Generator().manual_seed(3), shape, cfg)
    b = arch.input_concrete(torch.Generator().manual_seed(3), shape, cfg, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in a.items()} == {
        "tokens": ((2, 16), torch.int32),
        "vision_embeds": ((2, 16, cfg.d_model), torch.bfloat16),
        "positions3": ((3, 2, 32), torch.int32),
    }
    assert all(torch.equal(a[k], b[k]) for k in a) and float(a["vision_embeds"].float().std()) > 0.5
    params = arch.init_params(torch.Generator().manual_seed(0), cfg)
    a["positions3"] = torch.from_numpy(grid_positions3(2, 16, 32))
    with torch.no_grad():
        logits, caches = arch.prefill_fn(cfg)(params, a)
    assert logits.shape == (2, 1, cfg.vocab) and caches["pos0"]["k"].shape[2] == 32
