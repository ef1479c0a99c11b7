"""The port's sharding rule tables against the JAX package's, on the CPU.

``models/common.py``'s ``partition_specs``, the registry's
``input_pspecs`` / ``cache_pspecs`` (``shard_seq`` both ways), and
``launch/steps.py``'s ``_serve_params`` (``serve_optimized`` and
``_quant_pspecs``) equal JAX's for all ten architectures at their full
configs on the production meshes (16, 16) and (2, 16, 16) and the host
mesh (4, 1) -- JAX's fallbacks to replication included (qwen2-moe's 60
experts over 16, long_500k's batch of 1, kv heads that do not divide over
``model``).  The meshes are duck-typed (``axis_names`` and ``shape``): the
rule tables need no devices.  Also JAX's ``tests/test_distribution.py``
cases for the divisibility fallback and the activation-rules context, the
port's ``Mesh`` / ``P`` and the placement of ``distributed/spmd.py``.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.core.precision import PrecisionPolicy as JPolicy
from repro.core.precision import QTensor as JQTensor
from repro.launch import steps as jsteps
from repro.models.registry import SHAPES as J_SHAPES
from repro.models.registry import get_arch as j_get_arch
from repro.models.registry import list_archs as j_list_archs
from repro_torch.core.precision import PrecisionPolicy, QTensor
from repro_torch.distributed.sharding import (
    NamedSharding,
    P,
    activation_rules,
    constrain,
    logical_spec,
)
from repro_torch.distributed.spmd import Sharded, all_reduce, gather_tree, reshard, shard, shard_tree
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_host_mesh, make_mesh, make_production_mesh
from repro_torch.models.common import DTypePolicy, dense, logical_to_mesh, partition_spec, scalar_array
from repro_torch.models.registry import SHAPES, get_arch

ARCHS = sorted(j_list_archs())
RULES = r"(wq|wk|wv|wo|w_gate|w_up|w_down|in_proj|out_proj)$"


class _Mesh:
    """What JAX's rule tables read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


MESHES = {
    "16x16": _Mesh((16, 16), ("data", "model")),
    "2x16x16": _Mesh((2, 16, 16), ("pod", "data", "model")),
    "4x1": _Mesh((4, 1), ("data", "model")),
}


def _norm(tree):
    """Specs as nested dicts of tuples (a quantized leaf as ('Q', q, scale))."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, (QTensor, JQTensor)):
        return ("Q", _norm(tree.q), _norm(tree.scale), tree.bits, tuple(tree.shape))
    if isinstance(tree, (P, JP)):
        return tuple(tree)
    raise TypeError(type(tree))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_input_and_cache_specs_equal_jax(name, mesh):
    t, j, m = get_arch(name), j_get_arch(name), MESHES[mesh]
    for cfg in ("config", "reduced_config"):
        tc, jc = getattr(t, cfg), getattr(j, cfg)
        assert _norm(t.param_pspecs(m, tc)) == _norm(j.param_pspecs(m, jc)), cfg
    for shape_name, shape in SHAPES.items():
        jshape = J_SHAPES[shape_name]
        assert _norm(t.input_pspecs(m, shape)) == _norm(j.input_pspecs(m, jshape)), shape_name
        if shape.kind == "decode":
            for seq in (False, True):
                got = _norm(t.cache_pspecs(m, shape, shard_seq=seq))
                assert got == _norm(j.cache_pspecs(m, jshape, shard_seq=seq)), (shape_name, seq)


@pytest.mark.parametrize("name", ARCHS)
def test_serving_specs_equal_jax(name):
    """``serve_optimized`` (bf16, TP-only) and ``_quant_pspecs`` (int8 and
    int4: ``q`` the weight's spec, ``scale`` its last axis) on (16, 16)."""
    t, j, m = get_arch(name), j_get_arch(name), MESHES["16x16"]
    for bits, so in [(None, True), (8, False), (8, True), (4, True)]:
        tq = PrecisionPolicy(rules=((RULES, bits),)) if bits else None
        jq = JPolicy(rules=((RULES, bits),)) if bits else None
        _, tspecs = tsteps._serve_params(t, t.config, tq, so, m)
        _, jspecs = jsteps._serve_params(j, m, j.config, jq, so)
        assert _norm(tspecs) == _norm(jspecs), (bits, so)


def test_jax_fallbacks_are_exercised():
    """The cases above include each of JAX's fallbacks to replication."""
    m = MESHES["16x16"]
    moe = get_arch("qwen2-moe-a2.7b")
    assert moe.config.moe.n_experts == 60
    assert moe.param_pspecs(m)["blocks"]["pos0"]["moe"]["w_gate"][1] is None  # 60 % 16: no "model"
    assert get_arch("stablelm-1.6b").input_pspecs(m, SHAPES["long_500k"])["tokens"] == P(None, None)
    jamba = get_arch("jamba-v0.1-52b")
    assert jamba.config.n_kv_heads % 16
    assert jamba.cache_pspecs(m, SHAPES["decode_32k"])["pos0"]["k"] == P(None, "data", None, None, None)


# JAX's tests/test_distribution.py, on the port's Mesh and P


def test_partition_spec_divisibility_fallback():
    mesh = make_mesh((4, 4), ["cpu"] * 16)
    table = logical_to_mesh(mesh)
    ok = partition_spec(dense(8, 16, logical=("fsdp", "tp")), table, mesh)
    assert ok == P("data", "model")
    # 60 experts over a 4-way axis: 60 % 4 == 0 -> sharded; 30 % 4 != 0 -> dropped
    assert partition_spec(dense(60, 8, logical=("tp", None)), table, mesh)[0] == "model"
    assert partition_spec(dense(30, 8, logical=("tp", None)), table, mesh)[0] is None


def test_activation_rules_context():
    assert logical_spec("batch", None) is None  # inactive -> no constraints
    with activation_rules(make_mesh((1, 1), ["cpu"])):
        spec = logical_spec("batch", None, "tp")
        assert spec == P(("data",), None, "model")
    with activation_rules(make_mesh((1, 1), ["cpu"], ("pod", "model"))):
        spec = logical_spec("batch", None)
        assert spec == P(("pod",), None)


def test_param_spec_checks_its_logical_axes():
    with pytest.raises(ValueError, match="do not match shape"):
        dense(4, 8, logical=("fsdp",))
    assert dense(4, 8).logical == (None, None)
    s = scalar_array("ones")
    assert (s.shape, s.logical, s.init) == ((), (), "ones")
    assert partition_spec(s, logical_to_mesh(make_mesh((2, 2), ["cpu"] * 4))) == P()
    pol = DTypePolicy()
    assert pol.params == torch.float32 and pol.cast_in(torch.ones(2)).dtype == torch.bfloat16


# The port's own mesh vocabulary and placement


def test_meshes_refuse_what_does_not_multiply():
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ["cpu"] * 3)
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True)
    host = make_host_mesh("cpu")
    assert host.axis_names == ("data", "model") and host.shape == {"data": 1, "model": 1}
    m = make_mesh((2, 3), ["cpu"] * 6)
    assert m.size == 6 and m.devices.shape == (2, 3) and m == make_mesh((2, 3), ["cpu"] * 6)
    assert [m.index(m.coord(i)) for i in range(6)] == list(range(6))


@pytest.mark.parametrize(
    "shape,spec",
    [((2, 2), P("data", "model")), ((2, 2), P("model", None)), ((4, 1), P(None, "data")),
     ((1, 3), P()), ((2, 2), P(("data", "model"), None))],
)
def test_shard_gather_reshard_round_trip(shape, spec):
    mesh = make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))
    x = torch.arange(12 * 12, dtype=torch.float32).reshape(12, 12)
    s = shard(x, NamedSharding(mesh, spec))
    assert torch.equal(s.full(), x)
    ptrs = [t.data_ptr() for t in s.shards]
    assert len(set(ptrs)) == len(ptrs)  # every replica its own storage
    for other in (P(), P("data", None), P(None, "model"), P("model", "data")):
        r = reshard(s, other)
        assert r.spec == P(*other, *(None,) * (2 - len(other))) and torch.equal(r.full(), x)
        for i, t in enumerate(r.shards):
            assert torch.equal(t, shard(x, NamedSharding(mesh, other)).shards[i])


def test_all_reduce_is_ordered_and_every_member_gets_the_same_bits():
    mesh = make_mesh((2, 3), ["cpu"] * 6)
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(5, generator=gen) * 10 ** i for i in range(6)]
    out = all_reduce(xs, mesh, ("model",))
    for d in range(2):
        members = [mesh.index({"data": d, "model": m}) for m in range(3)]
        want = xs[members[0]] + xs[members[1]] + xs[members[2]]
        for k in members:
            assert torch.equal(out[k], want)
    mx = all_reduce(xs, mesh, ("data", "model"), op="max")
    assert all(torch.equal(t, torch.stack(xs).amax(0)) for t in mx)
    bf = [t.to(torch.bfloat16) for t in xs]  # 16-bit floats add in f32, round once
    got = all_reduce(bf, mesh, ("model",))[0]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (bf[0].float() + bf[1].float() + bf[2].float()).to(torch.bfloat16))


def test_constrain_reshards_a_sharded_value_under_rules():
    mesh = make_mesh((2, 2), ["cpu"] * 4)
    x = torch.arange(16.0).reshape(4, 4)
    s = shard(x, NamedSharding(mesh, P()))
    assert constrain(s, "batch", "tp") is s  # no rules: no-op
    with activation_rules(mesh):
        c = constrain(s, "batch", "tp")
        assert c.spec == P("data", "model") and torch.equal(c.full(), x)
        assert constrain(x, "batch", "tp") is x  # a plain tensor lives on one device


def test_shard_tree_places_quantized_leaves_by_their_specs():
    arch = get_arch("stablelm-1.6b")
    cfg = arch.reduced_config
    mesh = make_mesh((2, 2), ["cpu"] * 4)
    from repro_torch.core.precision import quantize_tree

    params = quantize_tree(arch.init_params(torch.Generator().manual_seed(0), cfg),
                           PrecisionPolicy(rules=((RULES, 4),)))
    _, specs = tsteps._serve_params(arch, cfg, PrecisionPolicy(rules=((RULES, 4),)), True, mesh)
    placed = shard_tree(params, specs, mesh)
    wq = placed["blocks"]["pos0"]["attn"]["wq"]
    assert isinstance(wq, QTensor) and isinstance(wq.q, Sharded)
    assert wq.q.spec == P(None, None, "model") and wq.scale.spec == P(None, "model")
    back = gather_tree(placed)
    for k in ("q", "scale"):
        np.testing.assert_array_equal(
            getattr(back["blocks"]["pos0"]["attn"]["wq"], k).numpy(),
            getattr(params["blocks"]["pos0"]["attn"]["wq"], k).numpy(),
        )


def test_the_gathers_backward_is_a_reduce_scatter():
    """FSDP's gradient: each block's gradient is the sum, over the shards
    that gathered it, of their gradients' matching slices."""
    mesh = make_mesh((2, 2), ["cpu"] * 4)
    w = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    s = shard(w, NamedSharding(mesh, P("data", "model")))
    s = s.map(lambda t: t.detach().requires_grad_(True))
    full = reshard(s, P(None, "model"))  # the all-gather over data
    weights = [torch.full_like(t, float(i + 1)) for i, t in enumerate(full.shards)]
    loss = sum((t * c).sum() for t, c in zip(full.shards, weights))
    grads = torch.autograd.grad(loss, s.shards)
    for i, g in enumerate(grads):
        c = mesh.coord(i)
        members = [mesh.index({"data": d, "model": c["model"]}) for d in range(2)]
        want = sum(weights[k][4 * c["data"] : 4 * c["data"] + 4] for k in members)
        assert torch.equal(g, want)
