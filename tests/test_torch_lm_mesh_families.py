"""The MoE, SSM, hybrid and VLM LMs over a ("data", "model") mesh of CPU shards: training.

``launch/steps.py``'s train step on meshes (2, 2), (4, 1), (1, 4) and
(1, 3) of ``cpu`` shards -- the last leaves most ``model``-sharded
dimensions of the reduced configs replicated by ``partition_spec``'s
divisibility fallback, while ``in_proj`` / ``conv_w`` split 552 / 288
three ways -- against the one-device port and against JAX's unsharded
step, for granite-moe under each expert layout (``"tp"``, ``"fsdp"``,
``"megatron"``, set by ``dataclasses.replace`` of ``moe.shard_experts`` on
both sides), qwen2-moe (shared experts, qkv biases, untied head), jamba
(attention, SSM, MoE and dense MLP in one group), mamba2 and qwen2-vl (4
patch embeddings and M-RoPE positions on a 2 x 2 grid, the loss over the
text tail).  Also the MoE aux against JAX's global-mean aux (and a
per-shard mean shown to miss it), the capacity drops against one device's,
``all_to_all`` and its backward, the ``"fsdp"`` layout's token exchange,
and a jamba ``TrainLoop`` killed on (2, 2) and resumed on (4, 1).  The
serving side is ``test_torch_lm_mesh_families_serve.py``.

Limits (``tests/test_torch_lm_mesh.py``'s): at f32 compute the loss, ce,
aux and grad norm within 1e-5 relative, gradients within 1e-4 of each
leaf's max |g|, parameters after an AdamW step within 1e-3 of each leaf's
max |w| where AdamW's update is conditioned (sqrt(nu_hat) > 100 eps, or no
gradient: ``test_torch_lm_families.py``'s rule, ROADMAP Queue 3).  Routing
must be the one device's (drops and assignments equal); the smallest
top-k margin is reported beside it.
"""

import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models.registry import ShapeSpec as JShape
from repro.models.registry import get_arch as j_get_arch
from repro.train import optimizer as jopt
from repro_torch.distributed import spmd
from repro_torch.distributed.spmd import Sharded, all_to_all, gather_tree, shard_tree
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import materialize, params_from_numpy, tree_leaves, tree_unflatten
from repro_torch.models.registry import ShapeSpec, get_arch
from repro_torch.models.routing_probe import record_routing
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import TrainLoop

SEQ, BATCH, N_VIS = 16, 4, 4
MESHES = [(2, 2), (4, 1), (1, 4), (1, 3)]
CASES = [
    ("granite-moe-1b-a400m", "tp"),
    ("granite-moe-1b-a400m", "fsdp"),
    ("granite-moe-1b-a400m", "megatron"),
    ("qwen2-moe-a2.7b", None),
    ("jamba-v0.1-52b", None),
    ("mamba2-780m", None),
    ("qwen2-vl-2b", None),
]
MOE_CASES = [c for c in CASES if c[0] in ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "jamba-v0.1-52b")]
_ids = lambda c: c[0] + (f"-{c[1]}" if c[1] else "")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shards' many small products gain nothing from
    more, and beside the other test workers extra threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def _cfg(cfg, layout, compute):
    cfg = dataclasses.replace(cfg, compute_dtype=compute)
    if layout is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, shard_experts=layout))
    return cfg


def _batch(name, vocab, d_model, seed=5):
    """Tokens and targets [BATCH, SEQ]; qwen2-vl: N_VIS bf16 patch
    embeddings on a 2 x 2 grid (t, h, w) = (0, r, c) before SEQ - N_VIS text
    tokens, whose positions continue from 2 on all three components."""
    rng = np.random.default_rng(seed)
    if name != "qwen2-vl-2b":
        toks = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    T = SEQ - N_VIS
    toks = rng.integers(0, vocab, (BATCH, T + 1)).astype(np.int32)
    r, c = np.divmod(np.arange(N_VIS), 2)
    vis = np.stack([np.zeros(N_VIS, np.int64), r, c])
    text = np.broadcast_to(2 + np.arange(T), (3, T))
    pos3 = np.broadcast_to(np.concatenate([vis, text], axis=1)[:, None], (3, BATCH, SEQ))
    return {
        "tokens": toks[:, :-1], "targets": toks[:, 1:],
        "vision_embeds": rng.standard_normal((BATCH, N_VIS, d_model)).astype(np.float32),
        "positions3": pos3.astype(np.int32).copy(),
    }


def _jx(batch):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "vision_embeds" else None) for k, v in batch.items()}


def _tx(batch):
    return {
        k: torch.from_numpy(v).to(torch.bfloat16) if k == "vision_embeds" else torch.from_numpy(v)
        for k, v in batch.items()
    }


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err / scale)


_REFS: dict = {}


def _refs(case):
    """JAX's loss, aux, gradients, stepped parameters and second moments, and
    the one-device port's gradients and step, from JAX's init at f32
    compute (computed once per architecture: an expert layout changes
    nothing on one device), with ``tcfg`` the case's layout."""
    name, layout = case
    if name not in _REFS:
        _REFS[name] = _one_device_refs(name)
    return {**_REFS[name], "tcfg": _cfg(_REFS[name]["tcfg"], layout, torch.float32)}


def _one_device_refs(name):
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg = _cfg(jarch.reduced_config, None, jnp.float32)
    tcfg = _cfg(tarch.reduced_config, None, torch.float32)
    jparams = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(name, jcfg.vocab, jcfg.d_model)
    jb, tb = _jx(batch), _tx(batch)
    loss_fn = jarch.loss_fn(jcfg)
    (_, jaux), jgrads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jb), has_aux=True))(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jstep = jsteps.build_train_step(jarch, JShape("t", SEQ, BATCH, "train"), j_host_mesh(), jcfg).jitted
    jstate = jopt.adamw(3e-4).init(jparams)
    jnew, jstate, jm = jstep(jparams, jstate, jb)  # donates jparams
    leaves = [t.clone().requires_grad_(True) for _, t in tree_leaves(tparams)]
    loss, _ = tarch.loss_fn(tcfg)(tree_unflatten(tparams, leaves), tb)
    tgrads = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    shape = ShapeSpec("t", SEQ, BATCH, "train")
    p1 = _clone(tparams)
    state1 = topt.adamw(3e-4).init([t for _, t in tree_leaves(p1)])
    p1, _, m1 = tsteps.build_train_step(tarch, shape, None, tcfg).jitted(p1, state1, tb)
    bias_c = 1 - 0.999 ** int(jstate.step)  # adamw's b2
    out = dict(
        tarch=tarch, tcfg=tcfg, tparams=tparams, batch=batch, tb=tb, shape=shape,
        jm={k: float(v) for k, v in jm.items()}, m1={k: float(v) for k, v in m1.items()},
        jaux=float(jaux["aux"]),
        jgrads=[np.asarray(g) for g in jax.tree.leaves(jgrads)], tgrads=tgrads,
        jnew=[np.asarray(x) for x in jax.tree.leaves(jnew)],
        held=[(np.asarray(nu) == 0) | (np.sqrt(np.asarray(nu) / bias_c) > 100 * 1e-8)
              for nu in jax.tree.leaves(jstate.nu)],
        p1=[t.numpy() for _, t in tree_leaves(p1)],
    )
    return out


def _check_metrics(got, *wants):
    for want in wants:
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-6), (k, got[k], want[k])


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_train_step_on_a_mesh_matches_one_device_and_jax(case, mesh_shape):
    r = _refs(case)
    mesh = _mesh(mesh_shape)
    arch, cfg = r["tarch"], r["tcfg"]
    step = tsteps.build_train_step(arch, r["shape"], mesh, cfg)
    assert step.mesh == mesh and step.specs[0] == arch.param_pspecs(mesh, cfg)
    # the gradients, each leaf's replicas summed, against JAX and one device
    sp = shard_tree(_clone(r["tparams"]), arch.param_pspecs(mesh, cfg), mesh)
    batch = tsteps._place_batch(r["tb"], arch.input_pspecs(mesh, r["shape"], cfg), mesh)
    loss, m, grads = tsteps.mesh_value_and_grad(arch.loss_fn(cfg), sp, batch)
    assert abs(float(loss) - r["jm"]["loss"]) <= 1e-5 * r["jm"]["loss"]
    assert abs(float(m["aux"]) - r["jaux"]) <= 1e-5 * max(r["jaux"], 1e-6)
    for (path, _), g, jg, tg in zip(tree_leaves(sp), grads, r["jgrads"], r["tgrads"]):
        full = g.full().numpy()
        _close(full, jg, 1e-4, f"grad vs JAX {path}")
        _close(full, tg, 1e-4, f"grad vs one device {path}")
    # the step: the caller's plain leaves placed on entry, then stepped
    params = _clone(r["tparams"])
    state = topt.adamw(3e-4).init([t for _, t in tree_leaves(params)])
    params, state, m = step.jitted(params, state, r["tb"])
    assert all(isinstance(t, Sharded) for _, t in tree_leaves(params)) and int(state.step) == 1
    _check_metrics({k: float(v) for k, v in m.items()}, r["jm"], r["m1"])
    for (path, t), jw, w1, held in zip(tree_leaves(gather_tree(params)), r["jnew"], r["p1"], r["held"]):
        assert held.any(), path
        _close(t.numpy()[held], jw[held], 1e-3, f"stepped vs JAX {path}")
        _close(t.numpy()[held], w1[held], 1e-3, f"stepped vs one device {path}")


# -- the MoE: aux, capacity, the token exchange ------------------------------


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("case", MOE_CASES, ids=_ids)
def test_aux_is_the_global_mean_and_a_per_shard_mean_misses_it(case, mesh_shape):
    """The load-balance aux over a data-sharded batch equals JAX's
    (products of means over the global batch); the mean of the data shards'
    own auxes -- each from its batch block alone, as a data-parallel loss
    without the all-reduce would take it -- fails the same check."""
    r = _refs(case)
    mesh = _mesh(mesh_shape)
    arch, cfg = r["tarch"], r["tcfg"]
    sp = shard_tree(_clone(r["tparams"]), arch.param_pspecs(mesh, cfg), mesh)
    with torch.no_grad():
        _, m = arch.loss_fn(cfg)(sp, r["tb"])
        dp = mesh_shape[0]
        rows = BATCH // dp
        planted = np.mean([
            float(arch.loss_fn(cfg)(r["tparams"], {k: (v[:, d * rows:(d + 1) * rows] if k == "positions3"
                                                       else v[d * rows:(d + 1) * rows])
                                                   for k, v in r["tb"].items()})[1]["aux"])
            for d in range(dp)
        ])
    tol = 1e-5 * r["jaux"]
    assert r["jaux"] > 0 and abs(float(m["aux"]) - r["jaux"]) <= tol
    assert abs(planted - r["jaux"]) > tol, (planted, r["jaux"])


def _routing(fn):
    with record_routing() as rec, torch.no_grad():
        fn()
    return rec


def test_record_routing_patches_only_inside_and_replays_what_it_is_given():
    """``record_routing`` patches ``_top_k`` only while it runs (the model
    code holds none of its state): recorded, the MoE's output is unchanged;
    a planted replay (every token's experts shifted by one) reroutes every
    token, and each counts as a flip beyond rounding."""
    from repro_torch.models import mlp, sharded_moe

    cfg = get_arch("granite-moe-1b-a400m").reduced_config.moe
    params = materialize(torch.Generator().manual_seed(0), mlp.moe_template(cfg))
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    seams = (mlp._top_k, sharded_moe._top_k, sharded_moe._route)
    with torch.no_grad():
        want, _ = mlp.moe_apply(cfg, params, x)
        with record_routing(keep=True) as kept:
            assert mlp._top_k is not seams[0] and sharded_moe._top_k is not seams[1]
            got, _ = mlp.moe_apply(cfg, params, x)
        assert (mlp._top_k, sharded_moe._top_k, sharded_moe._route) == seams
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        planted = [dict(r, idx=(r["idx"] + 1) % cfg.n_experts) for r in kept["routes"]]
        with record_routing(replay=planted) as rec:
            moved, _ = mlp.moe_apply(cfg, params, x)
    assert len(kept["routes"]) == rec["next"] == 1  # one chunk of 16
    assert rec["flips"] == 2 * 16 and rec["flip_ratio"] > 1 and rec["moved"] == 0
    assert not torch.allclose(moved, want)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("case", MOE_CASES, ids=_ids)
def test_capacity_drops_occur_and_equal_one_device(case, mesh_shape):
    """Capacity is per (batch row, chunk), so a batch split over ``data``
    drops exactly the assignments one device drops.  The forward at half
    JAX's capacity factor (so that every config drops), recorded: drops and
    assignments equal, and the smallest top-k margin reported with them."""
    r = _refs(case)
    arch = r["tarch"]
    cfg = dataclasses.replace(r["tcfg"], moe=dataclasses.replace(r["tcfg"].moe, capacity_factor=0.625))
    mesh = _mesh(mesh_shape)
    sp = shard_tree(_clone(r["tparams"]), arch.param_pspecs(mesh, cfg), mesh)
    one = _routing(lambda: arch.loss_fn(cfg)(r["tparams"], r["tb"]))
    got = _routing(lambda: arch.loss_fn(cfg)(sp, r["tb"]))
    assert one["drops"] > 0 and 0 < one["margin"] < 1
    assert (got["drops"], got["assigned"]) == (one["drops"], one["assigned"]), (got, one)
    assert got["margin"] == pytest.approx(one["margin"], rel=1e-3, abs=1e-7), (got, one)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_all_to_all_and_its_backward_are_the_inverse_exchange(mesh_shape):
    """``all_to_all`` over ``data``: shard j gets block j of every member's
    dim 0, concatenated along dim 1 in member order; swapping the dims
    undoes it; autograd's backward equals the inverse exchange of the
    output gradients."""
    mesh = _mesh(mesh_shape)
    dp = mesh_shape[0]
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(4 * dp, 3, 5, generator=g, requires_grad=True) for _ in range(mesh.size)]
    out = all_to_all(xs, mesh, "data", 0, 1)
    for i in range(mesh.size):
        c = mesh.coord(i)
        want = torch.cat([xs[mesh.index({**c, "data": k})][4 * c["data"]:4 * (c["data"] + 1)]
                          for k in range(dp)], dim=1)
        assert torch.equal(out[i], want)
    back = all_to_all(out, mesh, "data", 1, 0)
    assert all(torch.equal(b, x) for b, x in zip(back, xs))
    ws = [torch.randn(o.shape, generator=g) for o in out]
    grads = torch.autograd.grad(sum((w * o).sum() for w, o in zip(ws, out)), xs)
    inverse = all_to_all(ws, mesh, "data", 1, 0)
    assert all(torch.equal(a, b) for a, b in zip(grads, inverse))


def test_fsdp_experts_move_tokens_not_weights():
    """Under ``"fsdp"`` the experts stay split over ``data``: the capacity
    buffers travel by ``all_to_all`` (there and back, per MoE chunk), and no
    all-gather ever assembles a leaf of every expert."""
    r = _refs(("granite-moe-1b-a400m", "fsdp"))
    arch, cfg = r["tarch"], r["tcfg"]
    mesh = _mesh((2, 2))
    sp = shard_tree(_clone(r["tparams"]), arch.param_pspecs(mesh, cfg), mesh)
    assert sp["blocks"]["pos0"]["moe"]["w_gate"].spec == (None, "data", "model", None)
    calls, gathered = [], []
    a2a, gather = spmd.all_to_all, spmd.all_gather

    def spy_a2a(xs, *a):
        calls.append(tuple(xs[0].shape))
        return a2a(xs, *a)

    def spy_gather(xs, *a):
        out = gather(xs, *a)
        gathered.append(tuple(out[0].shape))
        return out

    from repro_torch.models import sharded, sharded_moe

    with mock.patch.object(sharded_moe, "all_to_all", spy_a2a), \
            mock.patch.object(spmd, "all_gather", spy_gather), \
            mock.patch.object(sharded, "all_gather", spy_gather):
        _, m, _ = tsteps.mesh_value_and_grad(arch.loss_fn(cfg), sp, tsteps._place_batch(
            r["tb"], arch.input_pspecs(mesh, r["shape"], cfg), mesh))
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    n_moe = cfg.n_layers  # granite: every layer's FF is an MoE, one chunk at SEQ 16
    assert len(calls) == 2 * n_moe
    assert calls[0][0] == E and calls[1][0] == E // 2  # all experts' buffers out, half back
    assert not any(len(s) >= 3 and s[-3:] in ((E, D // 2, F), (E, F, D // 2), (E, D, F)) for s in gathered)
    assert abs(float(m["aux"]) - r["jaux"]) <= 1e-5 * r["jaux"]


# -- the loop ------------------------------------------------------------------


def _losses(path):
    return {r["step"]: r["loss"] for r in map(json.loads, open(path)) if r["event"] == "step"}


def test_jamba_train_loop_killed_on_2x2_resumes_on_4x1(tmp_path):
    """A jamba ``TrainLoop`` on (2, 2) killed at step 3 and restored from its
    step-2 checkpoint logs the losses of an uninterrupted run; its
    checkpoint resumes on (4, 1), whose losses equal the (2, 2) run's
    continuation within 1e-5 (f32 compute)."""
    arch = get_arch("jamba-v0.1-52b")
    cfg = dataclasses.replace(arch.reduced_config, compute_dtype=torch.float32)

    def loop(mesh, run_dir, **kw):
        lp = TrainLoop("jamba-v0.1-52b", SEQ, BATCH, _mesh(mesh), str(tmp_path / run_dir), ckpt_every=2,
                       log_every=1, device="cpu", **kw)
        lp.arch, lp.cfg = dataclasses.replace(arch, reduced_config=cfg), cfg
        return lp

    clean, failed = loop((2, 2), "a"), loop((2, 2), "b", fail_at_step=3)
    out, got = clean.run(4), failed.run(4)
    assert out["final_step"] == got["final_step"] == 4 and got["failures"] == 1
    assert _losses(failed._metrics_path) == _losses(clean._metrics_path)
    more22, loop41 = loop((2, 2), "a"), loop((4, 1), "b")
    assert more22.run(6)["final_step"] == loop41.run(6)["final_step"] == 6
    a, b = _losses(more22._metrics_path), _losses(loop41._metrics_path)
    for s in (4, 5):
        assert abs(a[s] - b[s]) <= 1e-5 * abs(a[s]), (s, a[s], b[s])
