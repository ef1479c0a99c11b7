"""Whisper over a ("data", "model") mesh of CPU shards, on the CPU.

``launch/steps.py``'s train / prefill / decode steps for whisper-medium's
reduced config (2 + 2 layers, d_model 128, 4 heads, vocab 512) on meshes
(2, 2), (4, 1), (1, 4) and (1, 3) of ``cpu`` shards -- the last leaves
every ``model``-split dimension replicated (4 heads, d_model 128 and the
vocab do not divide by 3), so Q / K / V run whole there -- against the
one-device port and JAX's unsharded step (``make_host_mesh``, one device).

Limits (``tests/test_torch_lm_mesh.py``'s): at f32 compute the loss within
1e-5 relative, gradients within 1e-4 of each leaf's max |g|, the
parameters after an AdamW step within 1e-3 of each leaf's max |w| where
AdamW's update is conditioned (sqrt(nu_hat) > 100 eps, or no gradient:
``tests/test_torch_lm_mesh_families.py``'s rule; the zero-initialised
LayerNorm biases have elements whose gradient is rounding noise near eps,
where g / (|g| + eps) takes either sign); decode
logits within 1e-4 of max |logit| at f32 with equal greedy tokens, and 5 %
at bf16 (``serve_optimized`` int8, JAX's quant kernel in interpret mode)
with the greedy token equal wherever the top-2 margin is wider than that;
caches within 1e-4 (f32) / 5 % (bf16) of max(1, max |value|).
The sequence-split cross cache (``shard_cache_seq``) is
``test_torch_decode_seq_shard.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jp
from repro.kernels.quant_matmul import ops as j_qm_ops
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import whisper as jw
from repro.models.registry import ShapeSpec as JShape
from repro.models.registry import get_arch as j_get_arch
from repro.train import optimizer as jopt
from repro_torch.core import precision as tp
from repro_torch.distributed.spmd import Sharded, gather_tree, shard_tree
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import QUANT_RULES
from repro_torch.models.common import params_from_numpy, tree_leaves, tree_unflatten
from repro_torch.models.registry import ShapeSpec, get_arch
from repro_torch.train import optimizer as topt

NAME = "whisper-medium"
FRAMES, BATCH, STEPS = 32, 4, 3
MESHES = [(2, 2), (4, 1), (1, 4), (1, 3)]


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tp.QTensor):
        return tp.QTensor(tree.q.clone(), tree.scale.clone(), tree.bits, tree.shape)
    return tree.clone()


def _f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def _leaf_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert float(np.abs(got - want).max()) <= tol * max(float(np.abs(want).max()), 1e-30), what


def _models(compute):
    jarch, tarch = j_get_arch(NAME), get_arch(NAME)
    jcfg = dataclasses.replace(jarch.reduced_config, compute_dtype=getattr(jnp, compute))
    tcfg = dataclasses.replace(tarch.reduced_config, compute_dtype=getattr(torch, compute))
    return jarch, tarch, jcfg, tcfg, jarch.init_params(jax.random.PRNGKey(0), jcfg)


_TRAIN: dict = {}


def _train_refs():
    """JAX's loss, gradients and stepped parameters, and the one-device
    port's, from JAX's init at f32 compute (computed once)."""
    if _TRAIN:
        return _TRAIN
    jarch, tarch, jcfg, tcfg, jparams = _models("float32")
    rng = np.random.default_rng(24)
    toks = rng.integers(0, jcfg.vocab, (BATCH, jcfg.dec_max_len + 1)).astype(np.int32)
    batch = {"audio_frames": rng.standard_normal((BATCH, FRAMES, jcfg.d_model)).astype(np.float32),
             "tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.jit(jax.grad(lambda p: jarch.loss_fn(jcfg)(p, jb)[0]))(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jstep = jsteps.build_train_step(jarch, JShape("t", FRAMES, BATCH, "train"), j_host_mesh(), jcfg).jitted
    jnew, jstate, jm = jstep(jparams, jopt.adamw(3e-4).init(jparams), jb)  # donates jparams
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = [t.clone().requires_grad_(True) for _, t in tree_leaves(tparams)]
    loss, _ = tarch.loss_fn(tcfg)(tree_unflatten(tparams, leaves), tb)
    shape = ShapeSpec("t", FRAMES, BATCH, "train")
    p1 = _clone(tparams)
    one = tsteps.build_train_step(tarch, shape, None, tcfg).jitted
    p1, _, m1 = one(p1, topt.adamw(3e-4).init([t for _, t in tree_leaves(p1)]), tb)
    _TRAIN.update(
        tarch=tarch, tcfg=tcfg, tparams=tparams, tb=tb, shape=shape,
        jm={k: float(v) for k, v in jm.items()}, m1={k: float(v) for k, v in m1.items()},
        jgrads=[np.asarray(g) for g in jax.tree.leaves(jgrads)],
        tgrads=[g.numpy() for g in torch.autograd.grad(loss, leaves)],
        jnew=[np.asarray(x) for x in jax.tree.leaves(jnew)], p1=[t.numpy() for _, t in tree_leaves(p1)],
        held=[(np.asarray(nu) == 0) | (np.sqrt(np.asarray(nu) / (1 - 0.999)) > 100 * 1e-8)
              for nu in jax.tree.leaves(jstate.nu)],
    )
    return _TRAIN


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_whisper_train_step_on_a_mesh_matches_one_device_and_jax(mesh_shape):
    r = _train_refs()
    mesh, arch, cfg = _mesh(mesh_shape), r["tarch"], r["tcfg"]
    sp = shard_tree(_clone(r["tparams"]), arch.param_pspecs(mesh, cfg), mesh)
    batch = tsteps._place_batch(r["tb"], arch.input_pspecs(mesh, r["shape"], cfg), mesh)
    loss, _, grads = tsteps.mesh_value_and_grad(arch.loss_fn(cfg), sp, batch)
    assert abs(float(loss) - r["jm"]["loss"]) <= 1e-5 * r["jm"]["loss"]
    for (path, _), g, jg, tg in zip(tree_leaves(sp), grads, r["jgrads"], r["tgrads"]):
        _leaf_close(g.full().numpy(), jg, 1e-4, f"grad vs JAX {path}")
        _leaf_close(g.full().numpy(), tg, 1e-4, f"grad vs one device {path}")
    params = _clone(r["tparams"])
    state = topt.adamw(3e-4).init([t for _, t in tree_leaves(params)])
    step = tsteps.build_train_step(arch, r["shape"], mesh, cfg)
    assert step.mesh == mesh
    params, state, m = step.jitted(params, state, r["tb"])
    assert all(isinstance(t, Sharded) for _, t in tree_leaves(params)) and int(state.step) == 1
    for want in (r["jm"], r["m1"]):
        for k in ("loss", "ce", "grad_norm"):
            assert abs(float(m[k]) - want[k]) <= 1e-5 * abs(want[k]), (k, float(m[k]), want[k])
    for (path, t), jw_, w1, held in zip(tree_leaves(gather_tree(params)), r["jnew"], r["p1"], r["held"]):
        assert held.any(), path
        _leaf_close(t.numpy()[held], jw_[held], 1e-3, f"stepped vs JAX {path}")
        _leaf_close(t.numpy()[held], w1[held], 1e-3, f"stepped vs one device {path}")


# -- serving ---------------------------------------------------------------

SERVE_CASES = [("float32", None, False), ("bfloat16", 8, True)]  # compute, int bits, serve_optimized
_SERVE: dict = {}


def _serve_refs(case):
    """JAX's prefill and STEPS decode steps (seeded tokens), and the inputs."""
    if case in _SERVE:
        return _SERVE[case]
    compute, bits, so = case
    _, tarch, jcfg, tcfg, jparams = _models(compute)
    host = jax.tree.map(np.asarray, jparams)
    if so:  # serve_optimized: bf16 float leaves
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
        host = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), host)
    tparams = params_from_numpy(host, device="cpu")
    jpol = tpol = None
    if bits:
        jpol = jp.PrecisionPolicy(rules=((QUANT_RULES[0], bits),))
        tpol = tp.PrecisionPolicy(rules=((QUANT_RULES[0], bits),))
        jparams, tparams = jp.quantize_tree(jparams, jpol), tp.quantize_tree(tparams, tpol)
    rng = np.random.default_rng(25)
    frames = rng.standard_normal((BATCH, FRAMES, jcfg.d_model)).astype(np.float32)
    toks = [rng.integers(0, jcfg.vocab, (BATCH, 1)).astype(np.int32) for _ in range(STEPS)]
    j_qm_ops.enable(interpret=True)  # JAX's qdot through its kernel, as the port's
    try:
        jc = jax.jit(lambda p, f: jw.whisper_prefill(jcfg, p, f))(jparams, jnp.asarray(frames))
        jpre = jax.tree.map(np.asarray, jc)
        jdec, step = [], jax.jit(lambda p, c, x, n: jw.whisper_decode_step(jcfg, p, c, x, n))
        for t, tok in enumerate(toks):
            lg, jc = step(jparams, jc, jnp.asarray(tok), jnp.full((BATCH,), t, jnp.int32))
            jdec.append(np.asarray(lg, np.float32))
    finally:
        j_qm_ops.disable()
    out = dict(tarch=tarch, tcfg=tcfg, tparams=tparams, tpol=tpol, frames=torch.from_numpy(frames),
               toks=toks, jpre=jpre, jdec=jdec, jcache=jax.tree.map(np.asarray, jc))
    _SERVE[case] = out
    return out


def _serve_run(r, mesh, so):
    """The prefill (its caches kept whole) and STEPS decode steps through the step builders."""
    arch, cfg = r["tarch"], r["tcfg"]
    shape = lambda kind: ShapeSpec(kind, FRAMES, BATCH, kind)
    pre = tsteps.build_prefill_step(arch, shape("prefill"), mesh, cfg, quant=r["tpol"], serve_optimized=so)
    dec = tsteps.build_decode_step(arch, shape("decode"), mesh, cfg, quant=r["tpol"], serve_optimized=so)
    params = _clone(r["tparams"])
    with torch.no_grad():
        caches = pre.jitted(params, {"audio_frames": r["frames"]})
        whole = lambda c: {p: {k: t.full() if isinstance(t, Sharded) else t.clone() for k, t in d.items()}
                           for p, d in c.items()}
        prefilled = whole(caches)
        logits = []
        for t, tok in enumerate(r["toks"]):
            cur = torch.full((BATCH,), t, dtype=torch.int32)
            lg, caches = dec.jitted(params, caches, {"tokens": torch.from_numpy(tok), "cur_len": cur})
            logits.append(lg)
    return prefilled, logits, whole(caches)


def _check_logits(got, want, tol):
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * tol * scale
    if tol < 1e-3:
        assert decided.all(), "a near-tie in the f32 logits: pick another seed"
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: f"{c[0]}-int{c[1]}-so{int(c[2])}")
def test_whisper_prefill_and_decode_on_a_mesh_match_one_device_and_jax(case, mesh_shape):
    r = _serve_refs(case)
    tol = 1e-4 if case[0] == "float32" else 0.05
    one = _serve_run(r, None, case[2])
    got = _serve_run(r, _mesh(mesh_shape), case[2])
    for g, o, j in zip(got[1], one[1], r["jdec"]):
        assert not isinstance(g, Sharded) and g.shape == (BATCH, 1, r["tcfg"].vocab)
        _check_logits(g, o, tol)
        _check_logits(g, j, tol)
    for caches, want in [(got[0], one[0]), (got[0], r["jpre"]), (got[2], one[2]), (got[2], r["jcache"])]:
        for part in ("self", "cross"):
            for k in ("k", "v", "len"):
                g, w = _f32(caches[part][k]), _f32(want[part][k])
                np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1.0, np.abs(w).max()))
    assert got[2]["self"]["len"].tolist() == [[STEPS] * BATCH] * r["tcfg"].n_dec_layers
