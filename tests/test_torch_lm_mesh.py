"""The dense LM over a ("data", "model") mesh of four CPU shards, on the CPU.

``launch/steps.py``'s train / prefill / decode steps on meshes (2, 2),
(4, 1), (1, 4) and (1, 3) of ``cpu`` shards -- the last leaves every
``model``-sharded dimension of the reduced configs replicated by
``partition_spec``'s divisibility fallback -- against the one-device port
and against JAX's unsharded step, for stablelm (partial rotary, untied
head) and gemma2 (sliding window, softcaps, tied embeddings, GQA whose kv
heads do not divide over a 4-way ``model`` axis).

Limits (``tests/test_torch_lm_train_step.py``'s): at f32 compute the loss
within 1e-5 relative, gradients within 1e-4 of each leaf's max |g|, the
parameters after an AdamW step within 1e-3 of each leaf's max |w|;
prefill and decode logits within 1e-4 of the max |logit| at f32, 5 % at
bf16 with the greedy token equal wherever the top-2 margin is wider than
that (``tests/test_torch_lm_serve.py``'s rule).  Also ``bf16_gather``,
replicas written as distinct tensors on a mesh that repeats a device, a
checkpoint written under 2 x 2 restored under 4 x 1, a ``TrainLoop``
killed and resumed on a mesh, Whisper's steps built on a mesh, and
``shard_cache_seq`` refused only where the batch already splits over
``data``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jp
from repro.kernels.quant_matmul import ops as j_qm_ops
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import transformer as jt
from repro.models.registry import ShapeSpec as JShape
from repro.models.registry import get_arch as j_get_arch
from repro.train import optimizer as jopt
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import precision as tp
from repro_torch.distributed.sharding import DuplicateSpecError
from repro_torch.distributed.spmd import Sharded, gather_tree, shard_tree
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import QUANT_RULES
from repro_torch.models import transformer as tt
from repro_torch.models.common import params_from_numpy, tree_leaves, tree_unflatten
from repro_torch.models.registry import ShapeSpec, get_arch
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import TrainLoop

SEQ, BATCH = 16, 4
MESHES = [(2, 2), (4, 1), (1, 4), (1, 3)]


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def _models(name, compute):
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg = dataclasses.replace(jarch.reduced_config, compute_dtype=getattr(jnp, compute))
    tcfg = dataclasses.replace(tarch.reduced_config, compute_dtype=getattr(torch, compute))
    jparams = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    return jarch, tarch, jcfg, tcfg, jparams


def _batch(vocab, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _leaf_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


_TRAIN: dict = {}


def _train_refs(name, bf16_gather=False):
    """JAX's loss, gradients and stepped parameters, and the one-device
    port's, from JAX's init at f32 compute (computed once per case)."""
    key = (name, bf16_gather)
    if key in _TRAIN:
        return _TRAIN[key]
    jarch, tarch, jcfg, tcfg, jparams = _models(name, "float32")
    batch = _batch(jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jarch.loss_fn(jcfg)
    if bf16_gather:
        jgrads = None
    else:
        jgrads = jax.grad(lambda p: loss_fn(p, jb)[0])(jparams)
    jstep = jsteps.build_train_step(
        jarch, JShape("t", SEQ, BATCH, "train"), j_host_mesh(), jcfg, bf16_gather=bf16_gather
    ).jitted
    tparams = params_from_numpy(_host(jparams), device="cpu")
    state = jopt.adamw(3e-4).init(jparams)
    jnew, _, jm = jstep(jparams, state, jb)  # donates jparams
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = [t.clone().requires_grad_(True) for _, t in tree_leaves(tparams)]
    loss, _ = tarch.loss_fn(tcfg)(tree_unflatten(tparams, leaves), tb)
    tgrads = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    shape = ShapeSpec("t", SEQ, BATCH, "train")
    one = tsteps.build_train_step(tarch, shape, None, tcfg, bf16_gather=bf16_gather).jitted
    p1 = _clone(tparams)
    state1 = topt.adamw(3e-4).init([t for _, t in tree_leaves(p1)])
    p1, _, m1 = one(p1, state1, tb)
    out = dict(
        tarch=tarch, tcfg=tcfg, tparams=tparams, tb=tb, shape=shape,
        jm={k: float(v) for k, v in jm.items()}, m1={k: float(v) for k, v in m1.items()},
        jgrads=None if jgrads is None else [np.asarray(g) for g in jax.tree.leaves(jgrads)],
        tgrads=tgrads,
        jnew=[np.asarray(x) for x in jax.tree.leaves(jnew)],
        p1=[t.numpy() for _, t in tree_leaves(p1)],
    )
    _TRAIN[key] = out
    return out


def _check_metrics(got, *wants):
    for want in wants:
        for k in ("loss", "ce", "grad_norm"):
            assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), (k, got[k], want[k])


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", ["stablelm-1.6b", "gemma2-27b"])
def test_train_step_on_a_mesh_matches_one_device_and_jax(name, mesh_shape):
    r = _train_refs(name)
    mesh = _mesh(mesh_shape)
    arch, cfg = r["tarch"], r["tcfg"]
    step = tsteps.build_train_step(arch, r["shape"], mesh, cfg)
    assert step.mesh == mesh and step.specs[0] == arch.param_pspecs(mesh, cfg)
    # the gradients, each leaf's replicas summed, against JAX and one device
    sp = shard_tree(_clone(r["tparams"]), arch.param_pspecs(mesh, cfg), mesh)
    batch = tsteps._place_batch(r["tb"], arch.input_pspecs(mesh, r["shape"], cfg), mesh)
    loss, _, grads = tsteps.mesh_value_and_grad(arch.loss_fn(cfg), sp, batch)
    assert abs(float(loss) - r["jm"]["loss"]) <= 1e-5 * r["jm"]["loss"]
    for (path, _), g, jg, tg in zip(tree_leaves(sp), grads, r["jgrads"], r["tgrads"]):
        full = g.full().numpy()
        _leaf_close(full, jg, 1e-4, f"grad vs JAX {path}")
        _leaf_close(full, tg, 1e-4, f"grad vs one device {path}")
    # the step: the caller's plain leaves placed on entry, then stepped
    params = _clone(r["tparams"])
    state = topt.adamw(3e-4).init([t for _, t in tree_leaves(params)])
    params, state, m = step.jitted(params, state, r["tb"])
    assert all(isinstance(t, Sharded) for _, t in tree_leaves(params))
    assert all(isinstance(t, Sharded) for t in state.mu + state.nu) and int(state.step) == 1
    _check_metrics({k: float(v) for k, v in m.items()}, r["jm"], r["m1"])
    for (path, t), jw, w1 in zip(tree_leaves(gather_tree(params)), r["jnew"], r["p1"]):
        _leaf_close(t.numpy(), jw, 1e-3, f"stepped vs JAX {path}")
        _leaf_close(t.numpy(), w1, 1e-3, f"stepped vs one device {path}")


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_bf16_gather_casts_each_shard_before_its_gather(mesh_shape):
    """JAX's ``bf16_gather`` (f32 compute on bf16-valued weights): the loss
    within 1e-5 of the one-device port's and JAX's.  The gradients are bf16
    (the cast's backward), and the FSDP gathers' backward adds the data
    shards' bf16 gradients in bf16, as a bf16 reduce-scatter does: the grad
    norm within 2^-8 relative, and each parameter within 2 lr of JAX's (a
    bf16 gradient element whose sign differs moves AdamW's first update from
    -lr to +lr)."""
    r = _train_refs("stablelm-1.6b", bf16_gather=True)
    mesh = _mesh(mesh_shape)
    params = _clone(r["tparams"])
    state = topt.adamw(3e-4).init([t for _, t in tree_leaves(params)])
    step = tsteps.build_train_step(r["tarch"], r["shape"], mesh, r["tcfg"], bf16_gather=True).jitted
    params, state, m = step(params, state, r["tb"])
    m = {k: float(v) for k, v in m.items()}
    for want in (r["jm"], r["m1"]):
        for k in ("loss", "ce"):
            assert abs(m[k] - want[k]) <= 1e-5 * abs(want[k]), k
        assert abs(m["grad_norm"] - want["grad_norm"]) <= 2**-8 * want["grad_norm"]
    plain = _train_refs("stablelm-1.6b")
    assert abs(m["loss"] - plain["jm"]["loss"]) > 1e-6  # the cast changed the loss
    for (path, t), jw in zip(tree_leaves(gather_tree(params)), r["jnew"]):
        assert t.dtype == torch.float32  # the parameters stay f32
        assert float(np.abs(t.numpy() - jw).max()) <= 2 * 3e-4 + 1e-6, path


# -- serving ---------------------------------------------------------------

SERVE_CASES = [
    # name, compute, bits, serve_optimized, prefill length
    ("stablelm-1.6b", "float32", None, False, 24),
    ("stablelm-1.6b", "float32", 8, True, 24),
    ("stablelm-1.6b", "bfloat16", 8, True, 24),
    ("gemma2-27b", "float32", None, False, 80),  # past the 64-token local window
    ("gemma2-27b", "bfloat16", 4, True, 24),
]
_SERVE: dict = {}


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


def _serve_refs(case):
    """JAX's and the one-device port's prefill and three decode steps."""
    if case in _SERVE:
        return _SERVE[case]
    name, compute, bits, so, S = case
    jarch, tarch, jcfg, tcfg, jparams = _models(name, compute)
    host = _host(jparams)
    if so:  # serve_optimized: bf16 float leaves
        host = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), host)
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    tparams = params_from_numpy(host, device="cpu")
    jpol = tpol = None
    if bits:
        jpol = jp.PrecisionPolicy(rules=((QUANT_RULES[0], bits),))
        tpol = tp.PrecisionPolicy(rules=((QUANT_RULES[0], bits),))
        jparams, tparams = jp.quantize_tree(jparams, jpol), tp.quantize_tree(tparams, tpol)
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, jcfg.vocab, (BATCH, S)).astype(np.int32)
    dec_toks = [rng.integers(0, jcfg.vocab, (BATCH, 1)).astype(np.int32) for _ in range(3)]
    L = 12
    j_qm_ops.enable(interpret=True)  # JAX's qdot through its kernel, as the port's
    try:
        jl, _ = jt.prefill(jcfg, jparams, jnp.asarray(tokens))
        jc = jt.cache_init(jcfg, BATCH, L)
        cur = np.array([0, 5, 2, 7], np.int32)
        jdec = []
        for tok in dec_toks:
            lg, jc = jt.decode_step(jcfg, jparams, jc, jnp.asarray(tok), jnp.asarray(cur))
            jdec.append(np.asarray(lg, np.float32))
            cur = cur + 1
    finally:
        j_qm_ops.disable()
    out = dict(tarch=tarch, tcfg=tcfg, tparams=tparams, tpol=tpol, tokens=tokens, dec_toks=dec_toks,
               jl=np.asarray(jl, np.float32), jdec=jdec, jcache=_host(jc), L=L)
    _SERVE[case] = out
    return out


def _serve_run(r, mesh, S, so):
    """The prefill, three decode steps and the caches through the step builders."""
    arch, cfg = r["tarch"], r["tcfg"]
    pre = tsteps.build_prefill_step(arch, ShapeSpec("p", S, BATCH, "prefill"), mesh, cfg,
                                    quant=r["tpol"], serve_optimized=so)
    dec = tsteps.build_decode_step(arch, ShapeSpec("d", r["L"], BATCH, "decode"), mesh, cfg,
                                   quant=r["tpol"], serve_optimized=so)
    params = _clone_q(r["tparams"])
    logits, pcache = pre.jitted(params, {"tokens": torch.from_numpy(r["tokens"])})
    caches = tt.cache_init(cfg, BATCH, r["L"], device="cpu")
    cur = torch.tensor([0, 5, 2, 7], dtype=torch.int32)
    dec_logits = []
    for tok in r["dec_toks"]:
        lg, caches = dec.jitted(params, caches, {"tokens": torch.from_numpy(tok), "cur_len": cur})
        dec_logits.append(lg)
        cur = cur + 1
    return logits, pcache, dec_logits, caches


def _clone_q(tree):
    if isinstance(tree, dict):
        return {k: _clone_q(v) for k, v in tree.items()}
    if isinstance(tree, tp.QTensor):
        return tp.QTensor(tree.q.clone(), tree.scale.clone(), tree.bits, tree.shape)
    return tree.clone()


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: f"{c[0]}-{c[1]}-int{c[2]}-so{int(c[3])}")
def test_prefill_and_decode_on_a_mesh_match_one_device_and_jax(case, mesh_shape):
    name, compute, bits, so, S = case
    r = _serve_refs(case)
    one = _serve_run(r, None, S, so)
    got = _serve_run(r, _mesh(mesh_shape), S, so)
    assert got[0].shape == (BATCH, 1, r["tcfg"].vocab) and not isinstance(got[0], Sharded)
    _check_logits(got[0], one[0], compute)
    _check_logits(got[0], r["jl"], compute)
    for g, o, j in zip(got[2], one[2], r["jdec"]):
        _check_logits(g, o, compute)
        _check_logits(g, j, compute)
    tol = 1e-4 if compute == "float32" else 0.05
    for caches_got, caches_want in [(got[1], one[1]), (got[3], one[3]), (got[3], r["jcache"])]:
        for pos in caches_want:
            for k in ("k", "v", "len"):
                g = _f32(caches_got[pos][k].full())
                w = _f32(caches_want[pos][k])
                np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1.0, np.abs(w).max()))


# -- trouble spots: aliasing, checkpoints, the loop, refusals --------------


def test_replicas_are_distinct_tensors_on_a_repeated_device():
    """Four shards of one CPU: every replica a leaf, a moment or a cache
    holds is its own storage, before and after a step, and a decode step
    advances every shard's ``len`` once."""
    arch = get_arch("stablelm-1.6b")
    cfg = arch.reduced_config
    mesh = _mesh((2, 2))
    shape = ShapeSpec("t", SEQ, BATCH, "train")
    params = shard_tree(arch.init_params(torch.Generator().manual_seed(0), cfg),
                        arch.param_pspecs(mesh, cfg), mesh)
    state = tsteps.init_opt_state(topt.adamw(3e-4), params)  # the moments laid out as the leaves
    assert [x.spec for x in state.mu] == [t.spec for _, t in tree_leaves(params)]
    batch = arch.input_concrete(torch.Generator().manual_seed(1), shape, cfg)

    def distinct(leaves):
        ptrs = [t.data_ptr() for x in leaves for t in x.shards]
        assert len(set(ptrs)) == len(ptrs)

    step = tsteps.build_train_step(arch, shape, mesh, cfg).jitted
    for _ in range(2):
        params, state, _ = step(params, state, batch)
        distinct([t for _, t in tree_leaves(params)] + state.mu + state.nu)
    norm = params["final_norm"]  # replicated over data and model
    assert norm.spec == (None,)
    before = [t.clone() for t in norm.shards]
    norm.shards[0].add_(1.0)  # writing one replica writes no other
    assert all(torch.equal(t, b) for t, b in zip(norm.shards[1:], before[1:]))
    dec = tsteps.build_decode_step(arch, ShapeSpec("d", 8, BATCH, "decode"), mesh, cfg).jitted
    caches = tt.cache_init(cfg, BATCH, 8, device="cpu")
    tok = torch.zeros((BATCH, 1), dtype=torch.int32)
    cur = torch.zeros((BATCH,), dtype=torch.int32)
    dec(params, caches, {"tokens": tok, "cur_len": cur})
    distinct([t for _, t in tree_leaves(caches)])
    assert caches["pos0"]["len"].spec == (None, "data")
    for t in caches["pos0"]["len"].shards:  # replicated over model: each advanced once
        assert torch.equal(t, torch.ones_like(t))


def test_checkpoint_written_on_2x2_restores_on_4x1(tmp_path):
    """Checkpoints hold whole leaves: a 2 x 2 state restored onto 4 x 1 (the
    elastic case) is the same state, and steps on from there as the 2 x 2
    run does."""
    r = _train_refs("stablelm-1.6b")
    arch, cfg, shape = r["tarch"], r["tcfg"], r["shape"]
    m22, m41 = _mesh((2, 2)), _mesh((4, 1))
    params = _clone(r["tparams"])
    state = topt.adamw(3e-4).init([t for _, t in tree_leaves(params)])
    params, state, _ = tsteps.build_train_step(arch, shape, m22, cfg).jitted(params, state, r["tb"])
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, (params, state), {"step": 1}, blocking=True)
    sh = arch.param_shardings(m41, cfg)
    flat = [s for _, s in tree_leaves(sh)]
    template = (params, state)
    shardings = (sh, type(state)(None, flat, flat))
    (p41, s41), user = ckpt.restore(template, shardings=shardings)
    assert user == {"step": 1}
    for (path, a), (_, b) in zip(tree_leaves(p41), tree_leaves(params)):
        assert a.mesh == m41 and a.spec == sh_spec(sh, path)
        assert torch.equal(a.full(), b.full()), path
    for a, b in zip(s41.mu + s41.nu, state.mu + state.nu):
        assert a.mesh == m41 and torch.equal(a.full(), b.full())
    _, _, m_41 = tsteps.build_train_step(arch, shape, m41, cfg).jitted(p41, s41, r["tb"])
    _, _, m_22 = tsteps.build_train_step(arch, shape, m22, cfg).jitted(params, state, r["tb"])
    _check_metrics({k: float(v) for k, v in m_41.items()}, {k: float(v) for k, v in m_22.items()})


def sh_spec(shardings, path):
    node = shardings
    for k in path.split("/"):
        node = node[k]
    return node.spec


def _losses(path):
    return {r["step"]: r["loss"] for r in map(json.loads, open(path)) if r["event"] == "step"}


def test_train_loop_resumes_on_a_mesh(tmp_path):
    """A ``TrainLoop`` on (2, 2) killed at step 3 and restored from its
    step-2 checkpoint logs the same losses as an uninterrupted run (the CPU
    is deterministic and the checkpoint exact); its checkpoint then resumes
    on (4, 1), and the losses there equal the (2, 2) run's continuation
    within 1e-5 (f32 compute: the meshes add in other orders)."""
    arch = get_arch("stablelm-1.6b")
    cfg = dataclasses.replace(arch.reduced_config, compute_dtype=torch.float32)

    def loop(mesh, run_dir, **kw):
        lp = TrainLoop("stablelm-1.6b", 16, 4, _mesh(mesh), str(tmp_path / run_dir), ckpt_every=2,
                       log_every=1, device="cpu", **kw)
        lp.arch, lp.cfg = dataclasses.replace(arch, reduced_config=cfg), cfg
        return lp

    clean, failed = loop((2, 2), "a"), loop((2, 2), "b", fail_at_step=3)
    out, got = clean.run(6), failed.run(6)
    assert out["final_step"] == got["final_step"] == 6 and got["failures"] == 1
    assert _losses(failed._metrics_path) == _losses(clean._metrics_path)
    more22, loop41 = loop((2, 2), "a"), loop((4, 1), "b")
    assert more22.run(8)["final_step"] == loop41.run(8)["final_step"] == 8
    a, b = _losses(more22._metrics_path), _losses(loop41._metrics_path)
    for s in (6, 7):
        assert abs(a[s] - b[s]) <= 1e-5 * abs(a[s]), (s, a[s], b[s])


@pytest.mark.parametrize("name", ["whisper-medium"])
def test_families_not_ported_refuse_a_mesh(name, tmp_path):
    """Every family now shards: Whisper's train, prefill and decode steps
    build and run on a (2, 2) mesh (``tests/test_torch_whisper_mesh.py``
    holds them to one device and JAX), and a ``TrainLoop`` takes the mesh
    (it feeds token batches only, as JAX's does: Whisper trains through
    ``build_train_step``).  One shard is the one-device code."""
    arch = get_arch(name)
    cfg = arch.reduced_config
    mesh = _mesh((2, 2))
    params = arch.init_params(torch.Generator().manual_seed(0), cfg)
    for build, shape in [
        (tsteps.build_train_step, ShapeSpec("t", 16, 4, "train")),
        (tsteps.build_prefill_step, ShapeSpec("p", 16, 4, "prefill")),
        (tsteps.build_decode_step, ShapeSpec("d", 16, 4, "decode")),
    ]:
        assert build(arch, shape, mesh, cfg).mesh == mesh
        assert build(arch, shape, _mesh((1, 1)), cfg).mesh is None  # one shard: the one-device code
    batch = arch.input_concrete(torch.Generator().manual_seed(1), ShapeSpec("p", 16, 4, "prefill"), cfg)
    with torch.no_grad():
        caches = tsteps.build_prefill_step(arch, ShapeSpec("p", 16, 4, "prefill"), mesh, cfg).jitted(params, batch)
        assert caches["cross"]["k"].spec == (None, "data", None, "model", None)
        dec = tsteps.build_decode_step(arch, ShapeSpec("d", 16, 4, "decode"), mesh, cfg).jitted
        logits, caches = dec(params, caches, {"tokens": torch.zeros((4, 1), dtype=torch.int32),
                                              "cur_len": torch.zeros((4,), dtype=torch.int32)})
    assert logits.shape == (4, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert TrainLoop(name, 16, 4, mesh, str(tmp_path), device="cpu").mesh is mesh


def test_shard_cache_seq_is_refused_on_a_mesh_and_inert_on_one_device():
    """``shard_cache_seq`` puts the caches' sequence over ``data``; it is
    refused (``DuplicateSpecError``, as JAX's) only where the batch already
    splits over ``data``, and changes nothing on one device.
    ``tests/test_torch_decode_seq_shard.py`` holds the decode to one device
    and JAX."""
    arch = get_arch("stablelm-1.6b")
    shape = ShapeSpec("d", 16, 4, "decode")
    with pytest.raises(DuplicateSpecError, match="'data'"):
        tsteps.build_decode_step(arch, shape, _mesh((2, 2)), arch.reduced_config, shard_cache_seq=True)
    tsteps.build_decode_step(arch, shape, None, arch.reduced_config, shard_cache_seq=True)
    one = tsteps.build_decode_step(arch, ShapeSpec("d", 16, 1, "decode"), _mesh((2, 2)), arch.reduced_config,
                                   shard_cache_seq=True)
    assert one.specs[1]["pos0"]["k"] == (None, None, "data", "model", None)
