"""The port's Whisper (``models/whisper.py``, ``configs/whisper_medium.py``
and the registry's audio branch) against the JAX package on the CPU, at the
reduced config (2 + 2 layers, d_model 128, 4 heads, vocab 512, decoder
context 32), with JAX's parameters carried over by ``params_from_numpy``.

Tolerances, as the port's LM tests hold them: at f32 compute encoder
states within 1e-5 of max |value|, loss within 1e-5 relative, logits
within 1e-5 (train forward) and 1e-4 (decode) of max |logit| with equal
greedy tokens, gradients within 1e-4 of each leaf's max |g|, caches within
1e-5 of each leaf's max |value|.  At bf16 compute logits within 5 % of max
|logit| and greedy tokens equal where the top-2 margin is wider than that:
``jax.nn.gelu`` and ``F.gelu(approximate="tanh")`` round some bf16 values
differently (``scripts/lm_bf16_drift.py`` measures the share and the drift
of the reduced model's logits).  Quantized comparisons run JAX with its
``quant_matmul`` kernel in interpret mode, as ``test_torch_lm_serve.py``
does, since JAX's default ``qdot`` rounds differently from the kernel.
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jp
from repro.kernels.quant_matmul import ops as j_qm_ops
from repro.models import whisper as jw
from repro.models.registry import SHAPES as J_SHAPES
from repro.models.registry import get_arch as j_get_arch
from repro_torch.core import precision as tp
from repro_torch.launch import serve as t_launch
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import whisper as tw
from repro_torch.models.common import params_from_numpy, tree_leaves
from repro_torch.models.registry import SHAPES, ShapeSpec, get_arch
from repro_torch.train import optimizer as topt

NAME = "whisper-medium"
RULES = t_launch.QUANT_RULES[0]


@pytest.fixture
def jax_quant_kernel():
    j_qm_ops.enable(interpret=True)
    yield
    j_qm_ops.disable()


def _models(compute="float32", quant_bits=None, **overrides):
    """(JAX cfg, port cfg, JAX params, port params) at the reduced size."""
    jcfg = dataclasses.replace(
        j_get_arch(NAME).reduced_config, compute_dtype=getattr(jnp, compute), **overrides
    )
    tcfg = dataclasses.replace(
        get_arch(NAME).reduced_config, compute_dtype=getattr(torch, compute), **overrides
    )
    jparams = j_get_arch(NAME).init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    if quant_bits:
        jparams = jp.quantize_tree(jparams, jp.PrecisionPolicy(rules=((RULES, quant_bits),)))
        tparams = tp.quantize_tree(tparams, tp.PrecisionPolicy(rules=((RULES, quant_bits),)))
    return jcfg, tcfg, jparams, tparams


def _frames(B, S, d, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _np(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(float(np.abs(want).max()), 1e-30)


def _leaves(tree):
    return {p: t for p, t in tree_leaves(tree)}


@pytest.mark.parametrize("which", ["reduced_config", "config"])
def test_templates_match_jax_leaf_by_leaf(which):
    t, j = get_arch(NAME), j_get_arch(NAME)
    got = {p: (tuple(s.shape), str(s.dtype).removeprefix("torch."), s.init, s.scale)
           for p, s in tree_leaves(t.template(getattr(t, which)))}
    want = {
        "/".join(str(k.key) for k in path): (tuple(s.shape), jnp.dtype(s.dtype).name, s.init, s.scale)
        for path, s in jax.tree_util.tree_leaves_with_path(
            j.template(getattr(j, which)), is_leaf=lambda x: hasattr(x, "logical")
        )
    }
    assert got == want
    n = sum(int(np.prod(s)) for s, *_ in got.values())
    assert (which == "config") == (n > 7e8)  # whisper-medium: ~0.76 B


def test_params_from_numpy_carries_the_nested_stacked_tree():
    _, tcfg, jparams, tparams = _models()
    want = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jparams)}
    got = _leaves(tparams)
    assert set(got) == set(want)
    assert got["enc_blocks/attn/wq"].shape == (tcfg.n_enc_layers, tcfg.d_model, tcfg.d_model)
    for p, v in want.items():
        np.testing.assert_array_equal(got[p].numpy(), v)


def test_sinusoids_match_jax():
    """The encoder's position table.  The port's frequencies are exp
    rounded correctly to f32; XLA's f32 exp is 1 ulp off on 6 of the 64 at
    d_model 128, and the angle multiplies that by the position, so the
    tables agree to one frequency ulp times the last position, length x
    2^-24 (64 positions: 1.9e-6 apart; 4096: 1.2e-4)."""
    for length in (64, 4096):
        want = np.asarray(jw._sinusoids(length, 128))
        got = tw._sinusoids(length, 128, "cpu").numpy()
        assert got.shape == want.shape and float(np.abs(got - want).max()) <= length * 2.0**-24


@pytest.mark.parametrize("S", [64, 4096])
def test_encode_matches_jax(S):
    """S = 4096 runs JAX's ``attend_chunked`` and the port's query-chunked
    plain code (train mode on every device; ``attend_chunked`` itself on the
    CPU, whose CPU branch is the same code).  There both packages take
    JAX's position table (:func:`test_sinusoids_match_jax` holds the two
    tables), so the comparison is of the blocks and the chunked attention."""
    jcfg, tcfg, jparams, tparams = _models()
    frames = _frames(1, S, tcfg.d_model)
    want = jw.whisper_encode(jcfg, jparams, jnp.asarray(frames))
    table = np.asarray(jw._sinusoids(S, tcfg.d_model))

    def no_flash(*a, **kw):
        raise AssertionError("train mode took attend_chunked")

    jax_table = mock.patch.object(tw, "_sinusoids", lambda *a: torch.from_numpy(table.copy()))
    with torch.no_grad(), jax_table if S >= 4096 else contextlib.nullcontext():
        with mock.patch.object(tattn, "attend_chunked", no_flash):
            train = tw.whisper_encode(tcfg, tparams, torch.from_numpy(frames), train=True)
        serve = tw.whisper_encode(tcfg, tparams, torch.from_numpy(frames))
    _close(train, want, 1e-5)
    _close(serve, want, 1e-5)


def test_forward_and_loss_match_jax():
    jcfg, tcfg, jparams, tparams = _models()
    frames, toks, tgts = _frames(2, 64, tcfg.d_model), _tokens(2, 32, 512), _tokens(2, 32, 512, 2)
    jlog = jw.whisper_forward(jcfg, jparams, jnp.asarray(frames), jnp.asarray(toks))
    jl, jm = jw.whisper_loss(jcfg, jparams, {"audio_frames": jnp.asarray(frames),
                                             "tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)})
    with torch.no_grad():
        tlog = tw.whisper_forward(tcfg, tparams, torch.from_numpy(frames), torch.from_numpy(toks))
        tl, tm = tw.whisper_loss(tcfg, tparams, {"audio_frames": torch.from_numpy(frames),
                                                 "tokens": torch.from_numpy(toks),
                                                 "targets": torch.from_numpy(tgts)})
    assert tlog.dtype == torch.float32
    _close(tlog, jlog, 1e-5)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert set(tm) == set(jm) == {"ce"} and float(tm["ce"]) == float(tl)


def test_loss_gradients_match_jax_grad():
    jcfg, tcfg, jparams, tparams = _models()
    b = {"audio_frames": _frames(2, 48, tcfg.d_model, 3), "tokens": _tokens(2, 20, 512, 4),
         "targets": _tokens(2, 20, 512, 5)}
    jg = jax.grad(lambda p: jw.whisper_loss(jcfg, p, {k: jnp.asarray(v) for k, v in b.items()})[0])(
        jparams
    )
    paths = [p for p, _ in tree_leaves(tparams)]
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(tparams)]
    loss, _ = tw.whisper_loss(tcfg, tparams, {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    want = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jg)}
    for path, g in zip(paths, grads):
        w = want[path]
        assert g.shape == w.shape, path
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * max(float(np.abs(w).max()), 1e-30), path


def test_prefill_matches_jax_and_gives_each_layer_its_own_self_cache():
    jcfg, tcfg, jparams, tparams = _models()
    frames = _frames(2, 40, tcfg.d_model, 6)
    want = jw.whisper_prefill(jcfg, jparams, jnp.asarray(frames))
    with torch.no_grad():
        got = tw.whisper_prefill(tcfg, tparams, torch.from_numpy(frames))
    L, H, dh = tcfg.n_dec_layers, tcfg.n_heads, tcfg.d_head
    assert got["cross"]["k"].shape == (L, 2, 40, H, dh) and got["cross"]["len"].dtype == torch.int32
    for name in ("k", "v"):
        _close(got["cross"][name], want["cross"][name], 1e-5)
        assert got["self"][name].shape == (L, 2, tcfg.dec_max_len, H, dh)
        assert not got["self"][name].any()
    assert got["cross"]["len"].tolist() == np.asarray(want["cross"]["len"]).tolist() == [[40, 40]] * L
    assert got["self"]["len"].tolist() == [[0, 0]] * L
    # each layer's self cache is its own storage: a write to layer 0 leaves layer 1 alone
    tw.KVCache.append_one(
        {n: t[0] for n, t in got["self"].items()}, torch.ones(2, 1, H, dh), torch.ones(2, 1, H, dh)
    )
    assert got["self"]["k"][0, :, 0].eq(1).all() and got["self"]["len"][0].tolist() == [1, 1]
    assert not got["self"]["k"][1].any() and got["self"]["len"][1].tolist() == [0, 0]


def _greedy_both(jcfg, tcfg, jparams, tparams, frames, steps, cur0=0):
    """``steps`` greedy decode steps from token 0 after a prefill, in both
    packages; yields (step, JAX logits, port logits, JAX caches, port caches)."""
    jc = jw.whisper_prefill(jcfg, jparams, jnp.asarray(frames))
    with torch.no_grad():
        tc = tw.whisper_prefill(tcfg, tparams, torch.from_numpy(frames))
    B = frames.shape[0]
    jtok, cur = np.zeros((B, 1), np.int32), np.full((B,), cur0, np.int32)
    ttok = torch.zeros(B, 1, dtype=torch.int32)
    for i in range(steps):
        jl, jc = jw.whisper_decode_step(jcfg, jparams, jc, jnp.asarray(jtok), jnp.asarray(cur))
        with torch.no_grad():
            tl, tc = tw.whisper_decode_step(tcfg, tparams, tc, ttok, torch.from_numpy(cur))
        yield i, jl, tl, jc, tc
        jtok = np.asarray(jl).argmax(-1).astype(np.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        cur = cur + 1


def _decided(want, tol):
    top2 = np.sort(want, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 2 * tol * np.abs(want).max()


def test_greedy_decode_matches_jax_step_by_step():
    """8 greedy steps: logits within 1e-4 of max |logit|, the same tokens,
    and after each step every cache leaf within 1e-5 of its max |value|
    (the cross cache untouched, the self cache's ``len`` counting)."""
    jcfg, tcfg, jparams, tparams = _models()
    frames = _frames(2, 24, tcfg.d_model, 7)
    for i, jl, tl, jc, tc in _greedy_both(jcfg, tcfg, jparams, tparams, frames, 8):
        _close(tl, jl, 1e-4)
        want = _np(jl)
        assert _decided(want, 1e-4).all(), "a near-tie in the f32 logits: pick another seed"
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), want.argmax(-1))
        for part in ("self", "cross"):
            for name in ("k", "v"):
                _close(tc[part][name], jc[part][name], 1e-5)
            np.testing.assert_array_equal(tc[part]["len"].numpy(), np.asarray(jc[part]["len"]))
        assert tc["self"]["len"].tolist() == [[i + 1, i + 1]] * tcfg.n_dec_layers


def test_decode_clamps_positions_past_the_decoder_context_as_jax():
    """``cur_len`` past ``dec_max_len`` reads the last learned position, and
    a self cache already full writes its last slot while ``len`` counts on."""
    jcfg, tcfg, jparams, tparams = _models()
    frames = _frames(2, 16, tcfg.d_model, 8)
    jc = jw.whisper_prefill(jcfg, jparams, jnp.asarray(frames))
    with torch.no_grad():
        tc = tw.whisper_prefill(tcfg, tparams, torch.from_numpy(frames))
    full = tcfg.dec_max_len + 3
    rng = np.random.default_rng(9)
    kv = rng.standard_normal(tc["self"]["k"].shape).astype(np.float32)
    jc["self"] = {"k": jnp.asarray(kv), "v": jnp.asarray(-kv),
                  "len": jnp.asarray(np.array([[full, 5]] * tcfg.n_dec_layers, np.int32))}
    tc["self"] = {"k": torch.from_numpy(kv.copy()), "v": torch.from_numpy(-kv),
                  "len": torch.tensor([[full, 5]] * tcfg.n_dec_layers, dtype=torch.int32)}
    cur = np.array([tcfg.dec_max_len + 7, 5], np.int32)
    tok = np.array([[3], [4]], np.int32)
    jl, jc = jw.whisper_decode_step(jcfg, jparams, jc, jnp.asarray(tok), jnp.asarray(cur))
    with torch.no_grad():
        tl, tc = tw.whisper_decode_step(tcfg, tparams, tc, torch.from_numpy(tok), torch.from_numpy(cur))
    _close(tl, jl, 1e-4)
    for name in ("k", "v"):
        _close(tc["self"][name], jc["self"][name], 1e-5)
    np.testing.assert_array_equal(tc["self"]["len"].numpy(), np.asarray(jc["self"]["len"]))
    assert tc["self"]["len"][0].tolist() == [full + 1, 6]


def test_int8_serving_matches_jax_kernel(jax_quant_kernel):
    """int8 block weights (``QUANT_RULES``; ``embed`` and ``dec_pos`` stay
    float) through prefill and 6 greedy steps, against JAX with its kernel."""
    jcfg, tcfg, jparams, tparams = _models(quant_bits=8)
    assert isinstance(tparams["enc_blocks"]["attn"]["wq"], tp.QTensor)
    assert isinstance(tparams["dec_blocks"]["mlp"]["w_down"], tp.QTensor)
    assert isinstance(tparams["embed"], torch.Tensor) and isinstance(tparams["dec_pos"], torch.Tensor)
    frames = _frames(2, 24, tcfg.d_model, 10)
    for _, jl, tl, jc, tc in _greedy_both(jcfg, tcfg, jparams, tparams, frames, 6):
        _close(tl, jl, 1e-4)
        want = _np(jl)
        np.testing.assert_array_equal(tl.argmax(-1).numpy()[_decided(want, 1e-4)],
                                      want.argmax(-1)[_decided(want, 1e-4)])
    for name in ("k", "v"):
        _close(tc["cross"][name], jc["cross"][name], 1e-5)


def test_bf16_decode_stays_within_the_lm_tolerance_of_jax():
    jcfg, tcfg, jparams, tparams = _models("bfloat16")
    frames = _frames(2, 24, tcfg.d_model, 11)
    for _, jl, tl, _, tc in _greedy_both(jcfg, tcfg, jparams, tparams, frames, 4):
        assert tc["self"]["k"].dtype == torch.bfloat16
        _close(tl, jl, 0.05)
        want = _np(jl)
        d = _decided(want, 0.05)
        np.testing.assert_array_equal(tl.argmax(-1).numpy()[d], want.argmax(-1)[d])


def test_input_and_cache_templates_match_jax_for_every_shape():
    t, j = get_arch(NAME), j_get_arch(NAME)
    for cfg_name in ("reduced_config", "config"):
        for name, shape in SHAPES.items():
            got = t.input_template(shape, getattr(t, cfg_name))
            want = j.input_template(J_SHAPES[name], getattr(j, cfg_name))
            assert {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in got.items()} == {
                k: (tuple(v.shape), v.dtype.name) for k, v in want.items()
            }, (cfg_name, name)
            got_c = {f"{p}/{n}": (s, str(d).removeprefix("torch."))
                     for p, c in t.cache_abstract(shape, getattr(t, cfg_name)).items()
                     for n, (s, d) in c.items()}
            want_c = {f"{p}/{n}": (tuple(v.shape), v.dtype.name)
                      for p, c in j.cache_abstract(J_SHAPES[name], getattr(j, cfg_name)).items()
                      for n, v in c.items()}
            assert got_c == want_c, (cfg_name, name)


def test_input_concrete_draws_frames_tokens_and_lengths():
    arch = get_arch(NAME)
    cfg = arch.reduced_config
    train = arch.input_concrete(torch.Generator().manual_seed(4), ShapeSpec("t", 64, 3, "train"), cfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in train.items()} == {
        "audio_frames": ((3, 64, cfg.d_model), torch.bfloat16),
        "tokens": ((3, cfg.dec_max_len), torch.int32),
        "targets": ((3, cfg.dec_max_len), torch.int32),
    }
    assert 0 <= int(train["tokens"].min()) and int(train["targets"].max()) < cfg.vocab
    assert float(train["audio_frames"].float().std()) > 0.5
    pre = arch.input_concrete(torch.Generator().manual_seed(4), ShapeSpec("p", 16, 2, "prefill"), cfg)
    assert set(pre) == {"audio_frames"} and pre["audio_frames"].shape == (2, 16, cfg.d_model)
    dec = arch.input_concrete(torch.Generator().manual_seed(4), ShapeSpec("d", 16, 2, "decode"), cfg)
    assert dec["tokens"].shape == (2, 1) and dec["cur_len"].tolist() == [8, 8]


def test_step_functions_run_whisper_on_the_cpu():
    """``build_prefill_step`` / ``build_decode_step`` with int8 weights (the
    serving template quantizes the stacked [L, K, N] leaves and leaves
    ``embed`` and ``dec_pos`` float), then ``build_train_step``: AdamW steps
    that lower the loss, the first equal to ``whisper_loss`` of the same
    parameters."""
    arch = get_arch(NAME)
    cfg = dataclasses.replace(arch.reduced_config, compute_dtype=torch.float32)
    policy = tp.PrecisionPolicy(rules=((RULES, 8),))
    params = arch.init_params(torch.Generator().manual_seed(0), cfg)
    qparams = tp.quantize_tree(params, policy)
    pshape, dshape = ShapeSpec("p", 32, 2, "prefill"), ShapeSpec("d", 32, 2, "decode")
    prefill = tsteps.build_prefill_step(arch, pshape, None, cfg, quant=policy)
    abs_params = prefill.abstract_args[0]
    assert isinstance(abs_params["dec_blocks"]["cross_attn"]["wk"], tp.QTensor)
    assert abs_params["dec_blocks"]["cross_attn"]["wk"].q == ((2, 128, 128), torch.int8)
    assert abs_params["embed"] == ((cfg.vocab, cfg.d_model), torch.float32)
    assert abs_params["dec_pos"] == ((cfg.dec_max_len, cfg.d_model), torch.float32)
    batch = arch.input_concrete(torch.Generator().manual_seed(1), pshape, cfg)
    with torch.no_grad():
        caches = prefill.jitted(qparams, batch)
        decode = tsteps.build_decode_step(arch, dshape, None, cfg, quant=policy)
        want = {f"{p}/{n}": s for p, c in decode.abstract_args[1].items() for n, (s, _) in c.items()}
        assert {f"{p}/{n}": tuple(t.shape) for p, c in caches.items() for n, t in c.items()} == want
        tok, cur = torch.zeros(2, 1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
        for _ in range(3):
            logits, caches = decode.jitted(qparams, caches, {"tokens": tok, "cur_len": cur})
            tok, cur = logits.argmax(-1).to(torch.int32), cur + 1
    assert logits.shape == (2, 1, cfg.vocab) and caches["self"]["len"].tolist() == [[3, 3]] * 2
    shape = ShapeSpec("t", 32, 2, "train")
    batch = arch.input_concrete(torch.Generator().manual_seed(2), shape, cfg)
    with torch.no_grad():
        first, _ = arch.loss_fn(cfg)(params, batch)
    opt = topt.adamw(1e-3)
    state = opt.init([t for _, t in tree_leaves(params)])
    step = tsteps.build_train_step(arch, shape, None, cfg, optimizer=opt)
    losses = []
    for _ in range(4):
        params, state, m = step.jitted(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[0] == float(first) and losses[-1] < losses[0]
    assert set(m) == {"ce", "loss", "grad_norm"}
