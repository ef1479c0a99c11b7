"""The MoE, SSM, hybrid and VLM LMs over a ("data", "model") mesh of CPU shards: serving.

``launch/steps.py``'s prefill and decode steps on meshes (2, 2), (4, 1),
(1, 4) and (1, 3) of ``cpu`` shards against the one-device port and JAX's
unsharded ``prefill`` / ``decode_step``: granite-moe under its three
expert layouts, qwen2-moe, jamba, mamba2 (prefills of two SSD chunks) and
qwen2-vl (patch embeddings and M-RoPE positions), each at f32 compute and
as bf16 ``serve_optimized`` with int8 block weights (JAX's quant kernel in
interpret mode).  Every cache leaf -- K / V / len and the SSM conv / state
-- after the prefill and after three decode steps, and each shard's block
of the model-split conv cache against the one-device cache's columns.
The training side is ``test_torch_lm_mesh_families.py``.

Limits (``tests/test_torch_lm_families.py``'s): at f32 compute logits within
1e-4 of max |logit| with equal greedy tokens, cache leaves within 1e-4 of
max(1, max |value|); at bf16 logits within 5 % of max |logit| -- or, for the configs in
``DRIFTS``, JAX's own bf16-vs-f32 distance where larger (reduced jamba: its
bf16 logits lie 28 % from its f32 ones at a 64-token prefill) -- with the greedy
token equal wherever the top-2 margin is wider than twice that, and bf16
cache leaves in RMS within 5 % or twice JAX's own bf16-vs-f32 RMS distance.
Against one device, the mesh's prefill replays the one-device run's MoE
routes (``models/routing_probe.py::record_routing``), so that the comparison sees one
routing: at f32 its own top k routes every token as one device does; at
bf16 a token it would route elsewhere must have a top-k margin below twice
the largest change of its router probabilities between the runs.  Against
JAX, the mesh routes by its own top k.
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
from repro_torch.core import precision as tp
from repro_torch.distributed.spmd import Sharded
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import QUANT_RULES
from repro_torch.models import transformer as tt
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import ShapeSpec, get_arch
from repro_torch.models.routing_probe import record_routing

BATCH, L_DEC, N_VIS = 4, 12, 4
MESHES = [(2, 2), (4, 1), (1, 4), (1, 3)]
# name, expert layout, compute, int bits, serve_optimized, prefill length
CASES = [
    (name, layout, compute, bits, so, S)
    for name, layout, S in [
        ("granite-moe-1b-a400m", "tp", 24),
        ("granite-moe-1b-a400m", "fsdp", 24),
        ("granite-moe-1b-a400m", "megatron", 24),
        ("qwen2-moe-a2.7b", None, 24),
        ("jamba-v0.1-52b", None, 64),  # two SSD chunks of 32
        ("mamba2-780m", None, 64),
        ("qwen2-vl-2b", None, 24),
    ]
    for compute, bits, so in [("float32", None, False), ("bfloat16", 8, True)]
]
_ids = lambda c: "-".join(str(x) for x in (c[0], c[1] or "", c[2], f"int{c[3]}"))
# the configs whose own bf16 run lies further than 5 % from its f32 run,
# JAX's and the port's alike: reduced jamba, 28 % of max |logit| at the
# prefill (2 x its cache leaves' RMS distance 37 %); the others here lie
# within 2.1 % (caches 3.1 %), so their limit is 5 % without the twin run
DRIFTS = ("jamba-v0.1-52b",)


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


def _f32(a):
    if isinstance(a, Sharded):
        a = a.full()
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def _dist(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _rms_rel(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / max(float(np.mean(b**2)), 1e-30)))


def _check_logits(got, want, tol):
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * tol * scale
    if tol == 1e-4:
        assert decided.all(), "a near-tie in the f32 logits: pick another seed"
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


def _check_caches(got, want, f32: bool, want_f32=None):
    """Every leaf of every pattern position (the sharded ones made whole);
    at bf16 in RMS, against 5 % or twice ``want_f32``'s distance."""
    assert sorted(got) == sorted(want)
    for pos in want:
        assert sorted(got[pos]) == sorted(want[pos]), pos
        for name in want[pos]:
            g, w = _f32(got[pos][name]), _f32(want[pos][name])
            assert g.shape == w.shape, (pos, name)
            if name == "len":
                np.testing.assert_array_equal(g, w)
            elif f32:
                atol = 1e-4 * max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{pos}/{name}")
            else:
                twin = 0.0 if want_f32 is None else _rms_rel(w, _f32(want_f32[pos][name]))
                limit = max(0.05, 2 * twin)
                assert _rms_rel(g, w) <= limit, (pos, name, _rms_rel(g, w), limit)


def _inputs(name, cfg, S, seed):
    rng = np.random.default_rng(seed)
    if name != "qwen2-vl-2b":
        return {"tokens": rng.integers(0, cfg.vocab, (BATCH, S)).astype(np.int32)}
    r, c = np.divmod(np.arange(N_VIS), 2)
    text = np.broadcast_to(2 + np.arange(S - N_VIS), (3, S - N_VIS))
    pos3 = np.concatenate([np.stack([np.zeros(N_VIS, np.int64), r, c]), text], axis=1)
    return {
        "tokens": rng.integers(0, cfg.vocab, (BATCH, S - N_VIS)).astype(np.int32),
        "vision_embeds": rng.standard_normal((BATCH, N_VIS, cfg.d_model)).astype(np.float32),
        "positions3": np.broadcast_to(pos3[:, None], (3, BATCH, S)).astype(np.int32).copy(),
    }


def _jx(inp):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "vision_embeds" else None) for k, v in inp.items()}


def _tx(inp):
    return {k: torch.from_numpy(v).to(torch.bfloat16) if k == "vision_embeds" else torch.from_numpy(v)
            for k, v in inp.items()}


_REFS: dict = {}


def _jax_run(cfg, params, inp, dec_toks):
    """JAX's prefill (logits, caches) and three decode steps (logits, caches)."""
    jl, jc = jt.prefill(cfg, params, jnp.asarray(inp["tokens"]), pos3=inp.get("positions3"),
                        vision_embeds=inp.get("vision_embeds"))
    cache = jt.cache_init(cfg, BATCH, L_DEC)
    cur = np.array([0, 5, 2, 7], np.int32)
    dec = []
    for tok in dec_toks:
        lg, cache = jt.decode_step(cfg, params, cache, jnp.asarray(tok), jnp.asarray(cur))
        dec.append(np.asarray(lg, np.float32))
        cur = cur + 1
    host = lambda t: jax.tree.map(np.asarray, t)
    return np.asarray(jl, np.float32), host(jc), dec, host(cache)


def _refs(case):
    """JAX's and the one-device port's prefill and three decode steps (and, at
    bf16 for the configs in DRIFTS, JAX's f32-compute twin on the same
    parameters), computed once per case but its expert layout (which
    changes nothing on one device), with ``tcfg`` the case's layout."""
    name, layout, compute, bits, so, S = case
    key = (name, compute, bits, so, S)
    if key not in _REFS:
        _REFS[key] = _one_device_refs(*key)
    r = _REFS[key]
    if layout is None:
        return r
    return {**r, "tcfg": dataclasses.replace(r["tcfg"], moe=dataclasses.replace(r["tcfg"].moe, shard_experts=layout))}


def _one_device_refs(name, compute, bits, so, S):
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg, tcfg = jarch.reduced_config, tarch.reduced_config
    jcfg = dataclasses.replace(jcfg, compute_dtype=getattr(jnp, compute))
    tcfg = dataclasses.replace(tcfg, compute_dtype=getattr(torch, compute))
    jparams = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    if so:  # serve_optimized: bf16 float leaves
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jpol = tpol = None
    if bits:
        jpol = jp.PrecisionPolicy(rules=((QUANT_RULES[0], bits),))
        tpol = tp.PrecisionPolicy(rules=((QUANT_RULES[0], bits),))
        jparams, tparams = jp.quantize_tree(jparams, jpol), tp.quantize_tree(tparams, tpol)
    inp = _inputs(name, jcfg, S, seed=S)
    rng = np.random.default_rng(S + 1)
    dec_toks = [rng.integers(0, jcfg.vocab, (BATCH, 1)).astype(np.int32) for _ in range(3)]
    j_qm_ops.enable(interpret=True)  # JAX's qdot through its kernel, as the port's
    try:
        want = _jax_run(jcfg, jparams, _jx(inp), dec_toks)
        twin = None
        if compute != "float32" and name in DRIFTS:
            twin = _jax_run(dataclasses.replace(jcfg, compute_dtype=jnp.float32), jparams, _jx(inp), dec_toks)
    finally:
        j_qm_ops.disable()
    r = dict(tarch=tarch, tcfg=tcfg, tparams=tparams, tpol=tpol, so=so, S=S, inp=inp,
             dec_toks=dec_toks, want=want, twin=twin)
    r["one"], r["one_routes"] = _run(r, None, keep=True)
    return r


def _clone_q(tree):
    if isinstance(tree, dict):
        return {k: _clone_q(v) for k, v in tree.items()}
    if isinstance(tree, tp.QTensor):
        return tp.QTensor(tree.q.clone(), tree.scale.clone(), tree.bits, tree.shape)
    return tree.clone()


def _run(r, mesh, **routing):
    """The prefill, three decode steps and the caches through the step
    builders, and the prefill's routing record (``record_routing``'s
    ``keep`` / ``replay``)."""
    arch, cfg, B = r["tarch"], r["tcfg"], BATCH
    pre = tsteps.build_prefill_step(arch, ShapeSpec("p", r["S"], B, "prefill"), mesh, cfg,
                                    quant=r["tpol"], serve_optimized=r["so"])
    dec = tsteps.build_decode_step(arch, ShapeSpec("d", L_DEC, B, "decode"), mesh, cfg,
                                   quant=r["tpol"], serve_optimized=r["so"])
    params = _clone_q(r["tparams"])
    with record_routing(**routing) as routes, torch.no_grad():
        logits, pcache = pre.jitted(params, _tx(r["inp"]))
    caches = tt.cache_init(cfg, B, L_DEC, device="cpu")
    cur = torch.tensor([0, 5, 2, 7], dtype=torch.int32)
    dec_logits = []
    with torch.no_grad():
        for tok in r["dec_toks"]:
            lg, caches = dec.jitted(params, caches, {"tokens": torch.from_numpy(tok), "cur_len": cur})
            dec_logits.append(lg)
            cur = cur + 1
    return (logits, pcache, dec_logits, caches), routes


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_prefill_and_decode_on_a_mesh_match_one_device_and_jax(case, mesh_shape):
    """The mesh against one device with the one-device MoE routes replayed,
    and its own routing against JAX's."""
    r = _refs(case)
    one_routes = r["one_routes"]
    mesh = _mesh(mesh_shape)
    pinned, routes = _run(r, mesh, replay=one_routes["routes"])
    own, _ = _run(r, mesh)
    one, want, twin = r["one"], r["want"], r["twin"]
    f32 = case[2] == "float32"

    def tol(w, w32):
        return 1e-4 if f32 else max(0.05, 0.0 if w32 is None else _dist(w, w32))

    for got, ref in ((pinned, one), (own, want)):
        assert got[0].shape == (BATCH, 1, r["tcfg"].vocab) and not isinstance(got[0], Sharded)
        _check_logits(got[0], ref[0], tol(want[0], twin and twin[0]))
        for t, (g, o) in enumerate(zip(got[2], ref[2])):
            _check_logits(g, o, tol(want[2][t], twin and twin[2][t]))
        _check_caches(got[1], ref[1], f32, twin and twin[1])
        _check_caches(got[3], ref[3], f32, twin and twin[3])
    assert routes["next"] == len(one_routes["routes"])  # every chunk replayed the one-device route
    if f32:  # the mesh's own top k routes every token as one device
        assert routes["flips"] == 0, routes
    else:  # bf16: only where the probabilities moved by more than half the top-k margin
        assert routes["flips"] == 0 or routes["flip_ratio"] <= 1, routes
    assert (routes["drops"], routes["assigned"]) == (one_routes["drops"], one_routes["assigned"])


@pytest.mark.parametrize("name,mesh_shape,split", [
    ("jamba-v0.1-52b", (2, 2), True),  # 2 kv heads over 2: conv 288 -> 144 a shard, state 4 of 8 heads
    ("jamba-v0.1-52b", (1, 4), False),  # 2 kv heads over 4: the caches replicated
    ("mamba2-780m", (2, 2), False),  # one kv head: replicated, while the SSD's heads are local
])
def test_conv_cache_blocks_are_the_one_device_columns(name, mesh_shape, split):
    """Each shard's block of the SSM caches, after the prefill and after
    three decode steps (which all-gather the conv cache over ``model`` and
    write every shard's block back in place), equals the one-device cache's
    columns of that block: ``conv`` split contiguously over conv_dim, not
    by heads (full jamba: 8448 -> 4224 a shard against 4096 of x), and
    ``state`` by heads."""
    r = _refs((name, None, "float32", None, False, 64))
    got, _ = _run(r, _mesh(mesh_shape))
    one = r["one"]
    tp = mesh_shape[1]
    for caches, ref in [(got[1], one[1]), (got[3], one[3])]:
        for pos, c in ref.items():
            if "conv" not in c:
                continue
            for leaf, dim in (("conv", 3), ("state", 2)):
                s = caches[pos][leaf]
                assert s.spec[dim] == ("model" if split else None), (pos, leaf, s.spec)
                for i, block in enumerate(s.shards):
                    co = s.mesh.coord(i)
                    want = c[leaf]
                    if split:
                        k = want.shape[dim] // tp
                        want = want.narrow(dim, co["model"] * k, k)
                    b = BATCH // mesh_shape[0]
                    want = want.narrow(1, co["data"] * b, b)
                    atol = 1e-4 * max(1.0, float(want.abs().max()))
                    torch.testing.assert_close(block, want, rtol=0, atol=atol)
