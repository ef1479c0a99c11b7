"""The port's LM train step -- ``launch/steps.py::build_train_step`` over
``lm_loss`` with AdamW -- against JAX's jitted step, on the CPU.

JAX's parameters and optimizer state (its ``AdamWState``, carried across by
``train/optimizer.py::adamw_state_from_numpy``) start both steps; the same
``SyntheticTokens`` batches feed them.  Tolerances: at f32 compute the loss
of every step within 1e-5 relative, and the parameters after 5 AdamW steps
within 1e-3 of each leaf's max |w| (PR 16's limit for trained weights); at
bf16 compute (the configs' default) the losses within 5 %.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.tokens import SyntheticTokens as JTokens
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models.registry import ShapeSpec as JShape
from repro.models.registry import get_arch as j_get_arch
from repro.train import optimizer as jopt
from repro_torch.core.precision import PrecisionPolicy, QTensor
from repro_torch.core.shard import make_mesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.common import params_from_numpy, tree_leaves
from repro_torch.models.registry import ShapeSpec, get_arch
from repro_torch.train import optimizer as topt

SEQ, BATCH, STEPS = 24, 2, 5


def _setup(name, compute):
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg = dataclasses.replace(jarch.reduced_config, compute_dtype=getattr(jnp, compute))
    tcfg = dataclasses.replace(tarch.reduced_config, compute_dtype=getattr(torch, compute))
    return jarch, tarch, jcfg, tcfg


def _batches(vocab, n):
    data = JTokens(vocab=vocab, seq_len=SEQ, batch=BATCH, seed=5)
    return [next(data) for _ in range(n)]


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize(
    "name,compute",
    [("stablelm-1.6b", "float32"), ("granite-moe-1b-a400m", "float32"),
     ("qwen2-moe-a2.7b", "float32"), ("stablelm-1.6b", "bfloat16")],
)
def test_train_steps_match_jax_from_carried_state(name, compute):
    """One JAX step first, so the carried state has nonzero moments and
    step 1; then 5 steps on each side from it."""
    jarch, tarch, jcfg, tcfg = _setup(name, compute)
    mesh = j_host_mesh()
    shape = JShape("t", SEQ, BATCH, "train")
    jstep = jsteps.build_train_step(jarch, shape, mesh, jcfg).jitted
    params = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    state = jopt.adamw(3e-4).init(params)
    batches = _batches(jcfg.vocab, STEPS + 1)
    params, state, _ = jstep(params, state, batches[0])
    tparams = params_from_numpy(_host(params), device="cpu")
    tstate = topt.adamw_state_from_numpy(_host(state), device="cpu")
    assert int(tstate.step) == 1 and len(tstate.mu) == len(tree_leaves(tparams))
    tstep = tsteps.build_train_step(tarch, ShapeSpec("t", SEQ, BATCH, "train"), None, tcfg).jitted
    for b in batches[1:]:
        params, state, jm = jstep(params, state, b)
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        want, got = float(jm["loss"]), float(tm["loss"])
        tol = 1e-5 if compute == "float32" else 0.05
        assert abs(got - want) <= tol * abs(want), (got, want)
        if compute == "float32":
            for k in ("ce", "aux", "grad_norm"):
                assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1e-6), k
    if compute != "float32":
        return
    jleaves = [np.asarray(x) for x in jax.tree.leaves(params)]
    for (path, t), w in zip(tree_leaves(tparams), jleaves):
        assert float(np.abs(t.numpy() - w).max()) <= 1e-3 * float(np.abs(w).max()), path
    back = topt.adamw_state_to_numpy(tstate, tparams)
    assert int(back["step"]) == int(state.step) == STEPS + 1
    for ours, theirs in [(back["mu"], state.mu), (back["nu"], state.nu)]:
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
            b = np.asarray(b)
            assert float(np.abs(a - b).max()) <= 1e-3 * max(float(np.abs(b).max()), 1e-30)


def test_adamw_state_round_trip_and_order():
    """JAX's AdamWState -> the port's flat lists (tree_leaves order) -> back."""
    jarch = j_get_arch("qwen2-moe-a2.7b")
    params = jarch.init_params(jax.random.PRNGKey(1), jarch.reduced_config)
    rng = np.random.default_rng(0)
    state = jopt.AdamWState(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), params),
        nu=jax.tree.map(lambda p: jnp.asarray(rng.random(p.shape), jnp.float32), params),
    )
    tparams = params_from_numpy(_host(params), device="cpu")
    t = topt.adamw_state_from_numpy(_host(state), device="cpu")
    assert t.step.dtype == torch.int32 and int(t.step) == 7
    for (path, _), m, w in zip(tree_leaves(tparams), t.mu, jax.tree.leaves(state.mu)):
        np.testing.assert_array_equal(m.numpy(), np.asarray(w), err_msg=path)
    back = topt.adamw_state_to_numpy(t, tparams)
    assert jax.tree.structure(back["nu"]) == jax.tree.structure(state.nu)
    for a, b in zip(jax.tree.leaves(back["nu"]), jax.tree.leaves(state.nu)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_train_step_takes_over_the_state_it_is_given():
    """JAX donates params and optimizer state; the port rebinds the caller's
    tree leaves and moment lists to the new tensors, so no second copy of
    the state stays alive."""
    arch = get_arch("stablelm-1.6b")
    cfg = arch.reduced_config
    params = arch.init_params(torch.Generator().manual_seed(0), cfg)
    opt = topt.adamw(3e-4)
    state = opt.init([t for _, t in tree_leaves(params)])
    shape = ShapeSpec("t", 16, 2, "train")
    step = tsteps.build_train_step(arch, shape, None, cfg, optimizer=opt).jitted
    batch = arch.input_concrete(torch.Generator().manual_seed(1), shape, cfg)
    old_embed, old_mu0 = params["embed"], state.mu[0]
    new_params, new_state, m = step(params, state, batch)
    assert new_params is params and new_state.mu is state.mu and new_state.nu is state.nu
    assert params["embed"] is not old_embed and state.mu[0] is not old_mu0
    assert int(new_state.step) == 1
    assert not any(t.requires_grad for _, t in tree_leaves(params))
    assert set(m) == {"ce", "aux", "loss", "grad_norm"} and not m["loss"].requires_grad


def test_step_builders_refuse_a_multi_device_mesh():
    """A mesh of several shards runs every family sharded, Whisper too (no
    builder refuses it any more).  A 1-D DeviceMesh counts as (n, 1) over
    ("data", "model"); one shard is one device."""
    shape = ShapeSpec("t", 16, 2, "train")
    two = make_mesh(2, devices=["cpu", "cpu"])
    audio = get_arch("whisper-medium")
    for build in (tsteps.build_train_step, tsteps.build_prefill_step, tsteps.build_decode_step):
        assert build(audio, shape, two, audio.reduced_config).mesh.shape == {"data": 2, "model": 1}
        assert build(audio, shape, make_mesh(1, devices=["cpu"]), audio.reduced_config).mesh is None
    moe = get_arch("granite-moe-1b-a400m")
    assert tsteps.build_train_step(moe, shape, two, moe.reduced_config).mesh.shape == {"data": 2, "model": 1}
    dense = get_arch("stablelm-1.6b")
    step = tsteps.build_train_step(dense, shape, make_mesh(4, devices=["cpu"] * 4), dense.reduced_config)
    assert step.mesh.shape == {"data": 4, "model": 1}


def test_serving_bundles_carry_templates_and_run():
    arch = get_arch("granite-moe-1b-a400m")
    cfg = arch.reduced_config
    policy = PrecisionPolicy(rules=((r"(wq|wk|wv|wo)$", 8),))
    pre = tsteps.build_prefill_step(arch, ShapeSpec("p", 16, 2, "prefill"), None, cfg, quant=policy,
                                    serve_optimized=True)
    abs_params, abs_batch = pre.abstract_args
    wq = abs_params["blocks"]["pos0"]["attn"]["wq"]
    assert isinstance(wq, QTensor) and wq.q == ((2, 128, 128), torch.int8)
    assert wq.scale == ((2, 128), torch.float32)
    assert abs_params["embed"] == ((512, 128), torch.bfloat16)
    assert abs_batch == {"tokens": ((2, 16), torch.int32)}
    dec = tsteps.build_decode_step(arch, ShapeSpec("d", 32, 2, "decode"), None, cfg)
    _, abs_cache, abs_batch = dec.abstract_args
    assert abs_cache["pos0"]["k"] == ((2, 2, 32, 2, 32), torch.bfloat16)
    assert abs_batch == {"tokens": ((2, 1), torch.int32), "cur_len": ((2,), torch.int32)}
    assert pre.name == "prefill:granite-moe-1b-a400m:p" and dec.name == "decode:granite-moe-1b-a400m:d"
    params = arch.init_params(torch.Generator().manual_seed(0), cfg)
    batch = arch.input_concrete(torch.Generator().manual_seed(2), ShapeSpec("p", 16, 2, "prefill"), cfg)
    logits, caches = pre.jitted(params, batch)
    assert logits.shape == (2, 1, cfg.vocab) and caches["pos0"]["k"].shape == (2, 2, 16, 2, 32)
