"""The sequence-sharded KV decode (``build_decode_step(...,
shard_cache_seq=True)``, the long_500k layout) over CPU shards, on the CPU.

The decode caches' sequence split over ``data`` (``cache_pspecs(...,
shard_seq=True)``): the shard whose block holds a row's ``len`` appends
there, and the attention's softmax runs in two passes over ``data``
(``models/sharded.py``).  Against the one-device port and JAX's unsharded
``decode_step`` on the same seeded cache, three steps at f32 compute:
stablelm, gemma2 (sliding window of 64 and softcaps; its 2 kv heads
replicated on the (2, 3) mesh, where Q / K / V are gathered), jamba (one
attention layer among SSM layers), stablelm with an int8 cache
(``kv_cache_bits=8``) and mamba2 (SSM caches only: the option changes
nothing).  The three rows of the batch (which does not divide over
``data``, so it is replicated there) start at ``len`` S/2 (every valid
entry in the first half; the append crosses into the second), past S/2,
and 10 (whole blocks masked).  Then Whisper's cross cache, sequence-split
by ``whisper_prefill(..., shard_seq=True)``.

Limits: logits within 1e-4 of max |logit| with equal greedy tokens
(``tests/test_torch_lm_mesh.py``'s f32 limit); after every step each
shard's block of every cache leaf within 1e-5 of max(1, max |value|) of
its slice of the one-device cache (an int8 cache: equal).  Where the batch
already splits over ``data`` -- and on (1, 4) / (1, 3), whose one-block
``data`` axis takes the batch -- the spec names ``data`` twice and the
step builder raises ``DuplicateSpecError``, as JAX's ``NamedSharding``
does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import transformer as jt
from repro.models import whisper as jw
from repro.models.registry import ShapeSpec as JShape
from repro.models.registry import get_arch as j_get_arch
from repro_torch.core.precision import tree_map
from repro_torch.distributed.sharding import DuplicateSpecError, NamedSharding
from repro_torch.distributed.spmd import Sharded, shard_tree
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tt
from repro_torch.models import whisper as tw
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import ShapeSpec, get_arch

S, STEPS = 96, 3
LENS = [S // 2, S // 2 + 20, 10]
MESHES = [(2, 2), (4, 1), (2, 3)]
CASES = [
    ("stablelm-1.6b", {}),
    ("gemma2-27b", {}),
    ("jamba-v0.1-52b", {}),
    ("stablelm-1.6b", {"kv_cache_bits": 8}),
    ("mamba2-780m", {}),
]


def _mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


def _check_logits(got, want):
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _check_blocks(sharded: Sharded, whole, what):
    """Each shard's block of ``sharded`` against its slice of ``whole``."""
    whole = torch.as_tensor(whole)
    mesh, tol = sharded.mesh, 1e-5 * max(1.0, float(whole.float().abs().max()))
    for i, block in enumerate(sharded.shards):
        idx = []
        for n, entry in zip(sharded.shape, sharded.spec):
            k = n // mesh.axis_size(entry)
            b = mesh.block_index(i, entry)
            idx.append(slice(b * k, (b + 1) * k))
        want = whole[tuple(idx)]
        assert block.shape == want.shape, what
        if block.dtype in (torch.int8, torch.int32):
            assert torch.equal(block, want), (what, i)
        else:
            assert float((block.float() - want.float()).abs().max()) <= tol, (what, i)


def _models(name, overrides):
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg = dataclasses.replace(jarch.reduced_config, compute_dtype=jnp.float32, **overrides)
    tcfg = dataclasses.replace(tarch.reduced_config, compute_dtype=torch.float32, **overrides)
    jparams = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    return tarch, jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _cache(tcfg, B, seed):
    """A seeded cache of ``S`` positions, ``len`` LENS, as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {}
    for pos, c in tt.cache_template(tcfg, B, S).items():
        out[pos] = {}
        for name, (shape, dt) in c.items():
            if name == "len":
                a = np.broadcast_to(np.array(LENS, np.int32), shape).copy()
            elif dt == torch.int8:
                a = rng.integers(-127, 128, shape).astype(np.int8)
            else:
                a = rng.standard_normal(shape).astype(np.float32)
            out[pos][name] = a
    return out


_REFS: dict = {}


def _refs(case):
    """JAX's and the one-device port's STEPS decode steps on the seeded cache."""
    key = (case[0], tuple(case[1].items()))
    if key in _REFS:
        return _REFS[key]
    name, overrides = case
    tarch, jcfg, tcfg, jparams, tparams = _models(name, overrides)
    B = len(LENS)
    cache = _cache(tcfg, B, 7)
    rng = np.random.default_rng(8)
    toks = [rng.integers(0, tcfg.vocab, (B, 1)).astype(np.int32) for _ in range(STEPS)]
    jc = jax.tree.map(jnp.asarray, cache)
    tc = {p: {k: torch.from_numpy(a.copy()) for k, a in c.items()} for p, c in cache.items()}
    jdec, tdec, tcaches = [], [], []
    step = jax.jit(lambda p, c, x, n: jt.decode_step(jcfg, p, c, x, n))
    for t, tok in enumerate(toks):
        cur = np.array(LENS, np.int32) + t
        lg, jc = step(jparams, jc, jnp.asarray(tok), jnp.asarray(cur))
        jdec.append(np.asarray(lg, np.float32))
        with torch.no_grad():
            tl, tc = tt.decode_step(tcfg, tparams, tc, torch.from_numpy(tok), torch.from_numpy(cur))
        tdec.append(tl.clone())
        tcaches.append({p: {k: v.clone() for k, v in c.items()} for p, c in tc.items()})
    out = dict(tarch=tarch, tcfg=tcfg, tparams=tparams, cache=cache, toks=toks, jdec=jdec, tdec=tdec,
               tcaches=tcaches)
    _REFS[key] = out
    return out


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0] + "".join(f"-{k}{v}" for k, v in c[1].items()))
def test_seq_sharded_decode_matches_one_device_and_jax(case, mesh_shape):
    r = _refs(case)
    arch, cfg, mesh = r["tarch"], r["tcfg"], _mesh(mesh_shape)
    B = len(LENS)
    dec = tsteps.build_decode_step(arch, ShapeSpec("d", S, B, "decode"), mesh, cfg, shard_cache_seq=True)
    c_specs = dec.specs[1]
    has_attn = any("k" in c for c in c_specs.values())
    assert has_attn == (case[0] != "mamba2-780m")
    for c in c_specs.values():
        if "k" in c:
            assert c["k"][1] is None and c["k"][2] == "data"  # batch replicated, sequence over data
    caches = {p: {k: torch.from_numpy(a.copy()) for k, a in c.items()} for p, c in r["cache"].items()}
    params = tree_map(lambda _, t: t, r["tparams"])  # the step rebinds this tree's leaves
    with torch.no_grad():
        for t, tok in enumerate(r["toks"]):
            cur = torch.tensor(LENS, dtype=torch.int32) + t
            lg, caches = dec.jitted(params, caches, {"tokens": torch.from_numpy(tok), "cur_len": cur})
            assert not isinstance(lg, Sharded) and lg.shape == (B, 1, cfg.vocab)
            _check_logits(lg, r["tdec"][t])
            _check_logits(lg, r["jdec"][t])
            for p, c in caches.items():
                for k, leaf in c.items():
                    _check_blocks(leaf, r["tcaches"][t][p][k], f"step {t} {p}/{k}")


_WHISPER: dict = {}


def _whisper_refs():
    """JAX's and the one-device port's Whisper prefill of 3 clips and STEPS
    decode steps (seeded tokens, f32)."""
    if _WHISPER:
        return _WHISPER
    tarch, jcfg, tcfg, jparams, tparams = _models("whisper-medium", {})
    B, frames_n = 3, 32
    rng = np.random.default_rng(9)
    frames = rng.standard_normal((B, frames_n, tcfg.d_model)).astype(np.float32)
    toks = [rng.integers(0, tcfg.vocab, (B, 1)).astype(np.int32) for _ in range(STEPS)]
    jc = jax.jit(lambda p, f: jw.whisper_prefill(jcfg, p, f))(jparams, jnp.asarray(frames))
    with torch.no_grad():
        tc = tw.whisper_prefill(tcfg, tparams, torch.from_numpy(frames))
    jdec, tdec, tcaches = [], [], []
    step = jax.jit(lambda p, c, x, n: jw.whisper_decode_step(jcfg, p, c, x, n))
    for t, tok in enumerate(toks):
        cur = np.full((B,), t, np.int32)
        lg, jc = step(jparams, jc, jnp.asarray(tok), jnp.asarray(cur))
        jdec.append(np.asarray(lg, np.float32))
        with torch.no_grad():
            tl, tc = tw.whisper_decode_step(tcfg, tparams, tc, torch.from_numpy(tok), torch.from_numpy(cur))
        tdec.append(tl.clone())
        tcaches.append({p: {k: v.clone() for k, v in c.items()} for p, c in tc.items()})
    _WHISPER.update(tarch=tarch, tcfg=tcfg, tparams=tparams, frames=torch.from_numpy(frames), toks=toks,
                    jdec=jdec, tdec=tdec, tcaches=tcaches, B=B, frames_n=frames_n)
    return _WHISPER


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_whisper_seq_sharded_cross_cache_matches_one_device_and_jax(mesh_shape):
    """``whisper_prefill(..., shard_seq=True)`` keeps each shard's ``data``
    block of the cross cache's sequence (the self cache is not split), and
    the decode step reads it by the two-pass softmax."""
    r = _whisper_refs()
    arch, cfg, mesh, B = r["tarch"], r["tcfg"], _mesh(mesh_shape), r["B"]
    shape = ShapeSpec("d", r["frames_n"], B, "decode")
    dec = tsteps.build_decode_step(arch, shape, mesh, cfg, shard_cache_seq=True)
    assert dec.specs[1]["cross"]["k"][2] == "data" and dec.specs[1]["self"]["k"][2] is None
    params = shard_tree(r["tparams"], arch.param_pspecs(mesh, cfg), mesh)
    with torch.no_grad():
        caches = tw.whisper_prefill(cfg, params, r["frames"], shard_seq=True)
        for part in ("self", "cross"):
            for k in ("k", "v", "len"):
                assert caches[part][k].spec == dec.specs[1][part][k], (part, k)
        for t, tok in enumerate(r["toks"]):
            cur = torch.full((B,), t, dtype=torch.int32)
            lg, caches = dec.jitted(params, caches, {"tokens": torch.from_numpy(tok), "cur_len": cur})
            _check_logits(lg, r["tdec"][t])
            _check_logits(lg, r["jdec"][t])
            for part, c in caches.items():
                for k, leaf in c.items():
                    _check_blocks(leaf, r["tcaches"][t][part][k], f"step {t} {part}/{k}")


@pytest.mark.parametrize("name", ["stablelm-1.6b", "whisper-medium"])
def test_shard_cache_seq_refuses_a_batch_split_over_data_as_jax(name):
    """The spec P(None, 'data', 'data', ...) -- batch and sequence over
    ``data`` -- raises ``DuplicateSpecError`` naming the axis, in the port's
    step builder and prefill as in JAX's ``NamedSharding``; a batch that
    does not divide over ``data`` takes the layout, and on one device the
    option changes nothing."""
    arch, jarch = get_arch(name), j_get_arch(name)
    cfg = arch.reduced_config
    for mesh_shape, B in [((2, 2), 4), ((4, 1), 8), ((1, 4), 3), ((1, 3), 1)]:
        shape = ShapeSpec("d", 16, B, "decode")
        with pytest.raises(DuplicateSpecError, match="'data'"):
            tsteps.build_decode_step(arch, shape, _mesh(mesh_shape), cfg, shard_cache_seq=True)
    shape = ShapeSpec("d", 16, 4, "decode")
    spec = arch.cache_pspecs(_mesh((2, 2)), shape, cfg, shard_seq=True)
    jspec = jarch.cache_pspecs(j_host_mesh(), JShape("d", 16, 4, "decode"), jarch.reduced_config, shard_seq=True)
    leaf = (lambda c: c["cross"]["k"]) if name == "whisper-medium" else (lambda c: c["pos0"]["k"])
    assert tuple(leaf(spec)) == tuple(leaf(jspec)) == (None, "data", "data", "model", None)
    with pytest.raises(Exception, match="duplicate entries for `data`") as err:
        jax.sharding.NamedSharding(j_host_mesh(), leaf(jspec))
    assert type(err.value).__name__ == DuplicateSpecError.__name__
    with pytest.raises(DuplicateSpecError):
        NamedSharding(_mesh((2, 2)), leaf(spec))
    assert tsteps.build_decode_step(arch, ShapeSpec("d", 16, 3, "decode"), _mesh((2, 2)), cfg,
                                    shard_cache_seq=True).mesh is not None
    assert tsteps.build_decode_step(arch, shape, None, cfg, shard_cache_seq=True).mesh is None
    if name == "whisper-medium":
        mesh = _mesh((2, 2))
        params = shard_tree(arch.init_params(torch.Generator().manual_seed(0), cfg),
                            arch.param_pspecs(mesh, cfg), mesh)
        with pytest.raises(DuplicateSpecError, match="'data'"):
            tw.whisper_prefill(cfg, params, torch.zeros(4, 16, cfg.d_model), shard_seq=True)
