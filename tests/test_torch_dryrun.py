"""The port's dry run (``launch/dryrun.py``) and its counters, on the CPU.

1. ``distributed/spmd.py::count_collectives`` against hand counts: one
   entry per ``all_gather`` / ``all_reduce`` / ``all_to_all`` call and per
   gather of ``reshard``, on (2, 2) and (4, 1) meshes of ``cpu`` shards,
   and the backward collectives of a small autograd graph (a gather's
   reduce-scatter, an all-reduce's all-reduce, an all-to-all's inverse),
   once each, also under ``checkpoint``'s recompute.
2. A meta pass against a real CPU pass of the same reduced steps on a
   (2, 2) mesh of ``cpu`` shards: equal FLOPs, collectives by op (counts
   and wire bytes) and kernel reports.  Below 4096 tokens both take the
   plain attention; ``quant_matmul`` reports the same work from its plain
   version on the CPU as from its meta branch.
3. Per-shard memory: a storage held by several shards counts on each, and
   the members of an ``all_reduce`` each hold their own copy of the sum.
4. The slice as a whole: the port's ``run_cell`` against JAX's, both with
   the reduced config, SHAPES cut to seq 64 x batch 4 and a (2, 2) mesh
   (JAX in a subprocess over four forced host devices; the port on the
   meta device).  Equal: the record's keys (but for JAX's ``lower_s`` /
   ``compile_s`` / ``probe_collectives`` and the port's ``pass_s`` /
   ``backward_collectives`` / ``kernels``), ``status``, ``n_devices``,
   ``n_groups``, ``model_flops_global``, ``bytes_per_device_structural``,
   ``capacity_structural`` and ``fits_hbm``.

   ``flops_per_device`` lies within FLOPS_BAND of JAX's: measured 0.858
   (stablelm train), 0.510 (stablelm decode) and 1.064 (granite-moe
   ``ep_data`` train).  The port counts the matmul-class operations that
   ``torch.utils.flop_counter`` has formulas for (mm, bmm, addmm, ...);
   XLA's cost analysis also counts every elementwise operation and
   reduction, which dominate a decode step of this width.  The port's
   ``"fsdp"`` experts move the tokens by all-to-all and compute on
   capacity-padded buffers, where XLA gathers the experts.

   Collectives, XLA's from the HLO of JAX's 2-group probe (the whole
   reduced model, every scan unrolled): the FSDP all-gathers of the parameters that both
   issue are equal in count and full bytes (``SAME_GATHERS``).  The rest
   differ, each for a named cause (``PORT_ONLY`` / ``XLA_ONLY``):
   - XLA gathers the int32 token ids over all four devices (``s32``
     all-gather after a collective-permute) for the vocab-parallel
     embedding and CE; the port's shards read their own batch block;
   - the decode step: the port gathers the embedding table's FSDP block as
     it gathers any leaf; XLA looks the token's rows up without it;
   - granite-moe ``ep_data``: XLA all-gathers the experts' weights
     (``f32[8,64,64]``, twice each), gathers the routed activations
     (``f32[2,64,128]``, ``f32[4,64,8]``, ``f32[2,128]``) and the tied
     embedding twice; the port gathers the router's block
     (``[128, 8]``) and the tokens' TP activations (``[2, 64, 320]``) and
     moves the tokens to the experts' owners by ``all_to_all``;
   - XLA re-lays attention heads with all-to-alls and combines its
     all-reduces into tuples; on the CPU it issues the gathers'
     transposes as all-reduces, where the port records reduce-scatters;
   - the port's ``full-gather`` brings the logits whole to the first
     device (``Sharded.full``), which XLA's partitioned step does not.
5. ``Arch.runs_shape`` / ``skip_reason`` equal JAX's for every arch x shape.
6. ``main`` writes its JSON on one reduced cell and exits 1 when a record
   has ``status: error``.

Also: the kernel wrappers' meta branches (allocation and reported work
only, validated as on the card), the meta production meshes and the
kernel route ``attend_chunked`` takes on meta tensors.
"""

import collections
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.distributed.hlo_analysis import parse_collectives as j_parse_collectives
from repro.models.registry import SHAPES as J_SHAPES
from repro.models.registry import get_arch as j_get_arch
from repro.models.registry import list_archs as j_list_archs
from repro_torch.distributed.hlo_analysis import _SHAPE_RE, _shape_bytes
from repro_torch.distributed.sharding import P
from repro_torch.distributed.spmd import (
    Sharded,
    all_gather,
    all_reduce,
    all_to_all,
    count_collectives,
    reshard,
)
from repro_torch.kernels import work
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import attention as attn
from repro_torch.models.registry import SHAPES, ShapeSpec, get_arch, list_archs

SEQ, BATCH = 64, 4


def _mesh(shape, dev="cpu"):
    return make_mesh(shape, [dev] * (shape[0] * shape[1]))


def _reduced(name):
    arch = get_arch(name)
    return dataclasses.replace(arch, config=arch.reduced_config)


def _entries(rec, backward=None):
    return sorted(
        (e["op"], e["bytes"], e["g"]) for e in rec.entries if backward is None or e["backward"] == backward
    )


# ---------------------------------------------------------------------------
# 1. the collective counter against hand counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_collectives_forward_hand_counts(shape):
    mesh = _mesh(shape)
    d, m, n = shape[0], shape[1], mesh.size
    xs = [torch.randn(2, 3) for _ in range(n)]
    with count_collectives() as rec:
        all_gather(xs, mesh, "data", 0)  # [2d, 3] f32 on every shard
        all_reduce([x.to(torch.bfloat16) for x in xs], mesh, ("data",))  # counted as issued: bf16
        all_to_all([torch.randn(4, 8) for _ in range(n)], mesh, "data", 0, 1)
        all_reduce(xs, mesh, ("model",))  # a (4, 1) mesh's model axis reduces nothing
        x = Sharded.from_local([torch.randn(2, 4) for _ in range(n)], mesh, P("data", "model"))
        reshard(x, P(None, "model"))  # a gather over data
        reshard(x, P(None, None))  # a gather over data, then one over model
        reshard(x, P("data", "model"))  # nothing moves
    want = [
        ("all-gather", 2 * d * 3 * 4, d),
        ("all-reduce", 2 * 3 * 2, d),
        ("all-to-all", 4 * 8 * 4, d),
        ("all-gather", 2 * d * 4 * 4, d),
        ("all-gather", 2 * d * 4 * 4, d),
    ]
    if m > 1:
        want += [("all-reduce", 2 * 3 * 4, m), ("all-gather", 2 * d * 4 * m * 4, m)]
    assert _entries(rec) == sorted(want)
    wire = {"all-gather": 1.0, "all-to-all": 1.0, "all-reduce": 2.0}
    total = sum(wire[op] * b * (g - 1) / g for op, b, g in want)
    assert rec.stats().per_device_wire_bytes == pytest.approx(total)
    assert rec.stats().n_ops == len(want)
    assert not any(e["backward"] for e in rec.entries)


def _small_graph(mesh, w):
    """An FSDP gather of ``w``, a local product, an all-reduce over model
    and an all-to-all over data; the loss sums every shard's output."""
    gathered = all_gather(w, mesh, "data", 0)  # [4, 3] f32: 48 B
    a = torch.arange(16.0).reshape(4, 4) / 16
    h = [a @ g for g in gathered]
    s = all_reduce(h, mesh, ("model",))  # [4, 3] f32: 48 B
    e = all_to_all(s, mesh, "data", 0, 1)  # 48 B
    return sum(t.square().sum() for t in e)


def test_collectives_backward_hand_counts():
    mesh = _mesh((2, 2))
    w = [torch.randn(2, 3, requires_grad=True) for _ in range(4)]
    with count_collectives() as rec:
        grads = torch.autograd.grad(_small_graph(mesh, w), w)
    assert all(g.shape == (2, 3) for g in grads)
    assert _entries(rec, backward=False) == [("all-gather", 48, 2), ("all-reduce", 48, 2), ("all-to-all", 48, 2)]
    # each transposed once, though four shards' gradients arrive
    assert _entries(rec, backward=True) == [("all-reduce", 48, 2), ("all-to-all", 48, 2), ("reduce-scatter", 48, 2)]
    assert rec.stats(backward=True).per_device_wire_bytes == pytest.approx(24 + 48 + 24)
    assert rec.stats().n_ops == 6
    # without autograd, no backward collective is pending
    with torch.no_grad(), count_collectives() as rec:
        _small_graph(mesh, w)
    assert len(rec.entries) == 3


def test_collectives_backward_under_recompute():
    """``checkpoint`` recomputes its body's gather in the backward (a
    forward entry, as XLA's remat re-gathers) and the reduce-scatter is
    recorded once."""
    mesh = _mesh((2, 2))
    w = [torch.randn(2, 3, requires_grad=True) for _ in range(4)]
    x = torch.randn(5, 4)

    def body(*ws):
        return tuple(x @ g for g in all_gather(list(ws), mesh, "data", 0))

    with count_collectives() as rec:
        outs = checkpoint(body, *w, use_reentrant=False)
        torch.autograd.grad(sum(o.sum() for o in outs), w)
    assert _entries(rec, backward=False) == [("all-gather", 48, 2)] * 2
    assert _entries(rec, backward=True) == [("reduce-scatter", 48, 2)]


# ---------------------------------------------------------------------------
# 2. a meta pass against a CPU pass of the same steps
# ---------------------------------------------------------------------------

PASSES = [
    ("stablelm-1.6b", "train", "baseline"),
    ("stablelm-1.6b", "prefill", "baseline"),
    ("stablelm-1.6b", "prefill", "serve_q8"),
    ("stablelm-1.6b", "decode", "baseline"),
    ("stablelm-1.6b", "decode", "serve_q4"),
    ("granite-moe-1b-a400m", "prefill", "serve_q8"),
    ("mamba2-780m", "decode", "serve_q8"),
    ("whisper-medium", "decode", "serve_q8"),
    ("gemma2-27b", "decode", "baseline"),
]


@pytest.mark.parametrize("name,kind,variant", PASSES)
def test_meta_pass_equals_cpu_pass(name, kind, variant):
    arch, shape = _reduced(name), ShapeSpec(kind, SEQ, BATCH, kind)
    got = {}
    for dev in ("cpu", "meta"):
        bundle = dryrun.build_step(arch, shape, _mesh((2, 2), dev), variant=variant)
        got[dev] = dryrun.run_pass(bundle, device=dev)
    cpu, meta = got["cpu"], got["meta"]
    assert meta["flops"] == cpu["flops"] > 0
    assert meta["collectives"].summary() == cpu["collectives"].summary()
    assert meta["collectives"].n_ops > 0
    assert meta["backward_collectives"] == cpu["backward_collectives"]
    assert meta["kernels"] == cpu["kernels"]
    if variant.startswith("serve_q"):
        assert meta["kernels"]["quant_matmul"]["calls"] > 0
    if kind == "train":
        assert meta["backward_collectives"]["n_ops"] > 0
    assert meta["memory"]["peak_memory_in_bytes"] >= meta["memory"]["argument_size_in_bytes"] > 0


# ---------------------------------------------------------------------------
# 3. per-shard memory
# ---------------------------------------------------------------------------


def test_storage_held_by_several_shards_counts_on_each():
    with dryrun.count_step(4) as c:
        t = torch.zeros(256)  # 1 KiB
        c.hold(t, (1, 3))
        assert c.live == [0, 1024, 0, 1024]
        v = t[10:20]  # a view: the same storage
        del t
        assert c.live == [0, 1024, 0, 1024]
        del v
        assert c.live == [0, 0, 0, 0]
        assert c.peak == [0, 1024, 0, 1024]


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_all_reduce_members_each_hold_the_sum(dev):
    mesh = _mesh((2, 2), dev)
    with dryrun.count_step(4) as c:
        xs = [torch.zeros(256, device=dev) for _ in range(4)]
        for i, x in enumerate(xs):
            c.hold(x, (i,))
        before = list(c.live)
        out = all_reduce(xs, mesh, ("model",))
        assert [a - b for a, b in zip(c.live, before)] == [1024] * 4
        assert len({o.untyped_storage()._cdata for o in out}) == 4
        del out
        assert c.live == before


def test_step_counter_attributes_ops_to_their_shard():
    mesh = _mesh((1, 2), "meta")
    with dryrun.count_step(2) as c:
        xs = [torch.zeros(64, 64, device="meta") for _ in range(2)]
        for i, x in enumerate(xs):
            c.hold(x, (i,))
        y = xs[1] @ xs[1]  # shard 1's product
        assert c.live == [64 * 64 * 4, 2 * 64 * 64 * 4]
        assert c.flops == 2 * 64 * 64 * 64
        z = torch.ones(64, 64, device="meta")  # no input: attributed at its first use
        assert c.live[0] == 64 * 64 * 4
        w = xs[0] + z
        assert c.live == [3 * 64 * 64 * 4, 2 * 64 * 64 * 4]
        del y, z, w
    assert mesh.size == 2


# ---------------------------------------------------------------------------
# 4. the slice as a whole against JAX's dry run
# ---------------------------------------------------------------------------

CELLS = [
    ("stablelm-1.6b", "train_4k", "baseline"),
    ("stablelm-1.6b", "decode_32k", "baseline"),
    ("granite-moe-1b-a400m", "train_4k", "ep_data"),
]
# (flops_per_device of the port) / (JAX's): the cause is in the docstring
FLOPS_BAND = (0.45, 1.15)
SAME_GATHERS = {
    CELLS[0]: {32768: 8, 65536: 6, 131072: 2},
    CELLS[1]: {32768: 8, 65536: 6, 131072: 1},
    CELLS[2]: {16384: 4, 32768: 4, 131072: 1},
}
PORT_ONLY = {CELLS[0]: {}, CELLS[1]: {131072: 1}, CELLS[2]: {4096: 2, 163840: 2}}
XLA_ONLY = {CELLS[0]: {}, CELLS[1]: {}, CELLS[2]: {1024: 3, 8192: 2, 65536: 4, 131072: 13}}

_JAX_CELLS = textwrap.dedent(
    """
    import dataclasses, json, os, pathlib, sys, tempfile
    import repro.launch.dryrun as d  # sets a 512-device count; replaced before JAX starts
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.models.registry import ShapeSpec, get_arch
    assert len(jax.devices()) == 4
    d.get_arch = lambda n: dataclasses.replace(get_arch(n), config=get_arch(n).reduced_config)
    d.SHAPES = {k: ShapeSpec(k, 64, 4, v.kind) for k, v in d.SHAPES.items()}
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    d.make_production_mesh = lambda multi_pod=False: mesh
    texts, parse = [], d.parse_collectives
    d.parse_collectives = lambda text: (texts.append(text), parse(text))[1]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape, variant in json.loads(sys.argv[1]):
            rec = d.run_cell(arch, shape, False, variant=variant, out_dir=pathlib.Path(tmp), verbose=False)
            rec.pop("traceback", None)
            assert rec["n_groups"] == 2  # the 2-group probe is the whole reduced model, unrolled
            rec["hlo"] = texts[-1]
            out["|".join((arch, shape, variant))] = rec
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([p for p in sys.path if p] + [env.get("PYTHONPATH", "")])
    res = subprocess.run(
        [sys.executable, "-c", _JAX_CELLS, json.dumps(CELLS)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


@pytest.fixture(scope="module")
def port_cells(tmp_path_factory, monkeypatch_module):
    out_dir = tmp_path_factory.mktemp("dryrun_torch")
    monkeypatch_module.setattr(dryrun, "get_arch", _reduced)
    monkeypatch_module.setattr(dryrun, "SHAPES", {k: ShapeSpec(k, SEQ, BATCH, v.kind) for k, v in SHAPES.items()})
    monkeypatch_module.setattr(
        dryrun, "make_production_mesh", lambda multi_pod=False, device="meta": _mesh((2, 2), device)
    )
    return {cell: dryrun.run_cell(*cell[:2], False, variant=cell[2], out_dir=out_dir, verbose=False) for cell in CELLS}


@pytest.fixture(scope="module")
def port_entries():
    """The forward collectives of each cell's pass: (op, full bytes, g)."""
    out = {}
    for name, shape, variant in CELLS:
        kind = SHAPES[shape].kind
        bundle = dryrun.build_step(_reduced(name), ShapeSpec(shape, SEQ, BATCH, kind), _mesh((2, 2), "meta"), variant=variant)
        with dryrun.count_step(4) as c:
            bundle.jitted(*dryrun.placed_args(bundle))
        out[(name, shape, variant)] = _entries(c.collectives, backward=False)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _xla_gathers(hlo: str) -> collections.Counter:
    """Full bytes of every f32 all-gather in XLA's HLO (the largest shape
    on its line, as ``parse_collectives`` reckons it)."""
    out = collections.Counter()
    for line in hlo.splitlines():
        m = re.search(r"=\s*(?:\([^)]*\)|\S+)\s+([a-z0-9-]+)\(", line)
        if m and m.group(1) == "all-gather":
            dt, dims = max(_SHAPE_RE.findall(line), key=lambda s: _shape_bytes(*s))
            if dt == "f32":
                out[_shape_bytes(dt, dims)] += 1
    return out


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_run_cell_against_jax(cell, jax_cells, port_cells, port_entries):
    jr, tr = jax_cells["|".join(cell)], port_cells[cell]
    assert tr["status"] == jr["status"] == "ok", tr.get("error")
    jax_only, port_only = {"lower_s", "compile_s", "probe_collectives", "hlo"}, {"pass_s", "backward_collectives", "kernels"}
    assert set(jr) - jax_only == set(tr) - port_only
    for k in ("n_devices", "n_groups", "model_flops_global", "bytes_per_device_structural",
              "capacity_structural", "fits_hbm", "kind", "variant", "model_flops_per_device"):
        assert tr[k] == jr[k], k
    ratio = tr["flops_per_device"] / jr["flops_per_device"]
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio
    assert set(tr["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes", "peak_memory_in_bytes"}
    # the arguments are the same leaves on the same specs
    assert tr["memory"]["argument_size_in_bytes"] == jr["memory"]["argument_size_in_bytes"]
    # the HLO is the one JAX's probe counted
    assert j_parse_collectives(jr["hlo"]).by_op == jr["probe_collectives"]
    # the parameter gathers both issue are equal; the rest are named
    port = collections.Counter(b for op, b, _ in port_entries[cell] if op == "all-gather")
    xla = _xla_gathers(jr["hlo"])
    assert port == collections.Counter(SAME_GATHERS[cell]) + collections.Counter(PORT_ONLY[cell])
    assert xla == collections.Counter(SAME_GATHERS[cell]) + collections.Counter(XLA_ONLY[cell])
    assert set(tr["collectives_surface"]["by_op"]) <= {"all-gather", "all-reduce", "all-to-all", "reduce-scatter", "full-gather"}
    if cell[0] == "stablelm-1.6b":
        assert {"collective-permute", "all-to-all"} <= set(jr["probe_collectives"])
        assert "all-to-all" not in tr["collectives_surface"]["by_op"]
    if "train" in cell[1]:
        assert tr["backward_collectives"]["by_op"]["reduce-scatter"]["count"] == sum(
            (collections.Counter(SAME_GATHERS[cell]) + collections.Counter(PORT_ONLY[cell])).values())
    else:
        assert "full-gather" in tr["collectives_surface"]["by_op"]


# ---------------------------------------------------------------------------
# 5. runs_shape / skip_reason
# ---------------------------------------------------------------------------


def test_runs_shape_matches_jax():
    assert list_archs() == j_list_archs()
    assert list(SHAPES) == list(J_SHAPES)
    for name in list_archs():
        arch, jarch = get_arch(name), j_get_arch(name)
        assert arch.skip_reason == jarch.skip_reason
        for shape in SHAPES:
            assert arch.runs_shape(shape) == jarch.runs_shape(shape), (name, shape)
    assert not all(get_arch(n).runs_shape(s) for n in list_archs() for s in SHAPES)


# ---------------------------------------------------------------------------
# 6. main
# ---------------------------------------------------------------------------


def test_main_writes_records_and_fails_on_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "get_arch", _reduced)
    monkeypatch.setattr(dryrun, "SHAPES", {k: ShapeSpec(k, SEQ, BATCH, v.kind) for k, v in SHAPES.items()})
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda multi_pod=False, device="meta": _mesh((2, 2), device))
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--variant", "serve_q8", "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "stablelm-1.6b__decode_32k__single__serve_q8.json").read_text())
    assert rec["status"] == "ok" and rec["kernels"]["quant_matmul"]["calls"] > 0
    assert rec["wire_bytes_per_device"] == rec["collectives_surface"]["wire_bytes_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")

    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "build_step", broken)
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k", "--out", str(tmp_path)])
    assert done.value.code == 1
    rec = json.loads((tmp_path / "stablelm-1.6b__train_4k__single.json").read_text())
    assert rec["status"] == "error" and "planted" in rec["error"]


def test_skipped_cell_record(tmp_path):
    skipping = [(n, s) for n in list_archs() for s in SHAPES if not get_arch(n).runs_shape(s)]
    name, shape = skipping[0]
    rec = dryrun.run_cell(name, shape, False, out_dir=tmp_path, verbose=False)
    assert rec["status"] == "skipped" and rec["reason"] == get_arch(name).skip_reason
    assert json.loads((tmp_path / f"{name}__{shape}__single.json").read_text()) == rec


# ---------------------------------------------------------------------------
# the kernels' meta branches, the meta meshes, the meta attention route
# ---------------------------------------------------------------------------


class _Sink:
    def __init__(self):
        self.calls = []

    def kernel_begin(self, name, flops, nbytes, operands=()):
        self.calls.append((name, flops, nbytes))

    def kernel_end(self):
        pass


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_meta_allocates_and_reports(bits):
    M, K, N = 48, 256, 384
    x = torch.empty(M, K, dtype=torch.bfloat16, device="meta")
    q = torch.empty(K, N // 2 if bits == 4 else N, dtype=torch.int8, device="meta")
    s = torch.empty(N, dtype=torch.float32, device="meta")
    before = quant_matmul.launches
    with work.listening(_Sink()) as sink:
        out = quant_matmul(x, q, s, bits=bits, out_dtype=torch.float32)
    assert out.device.type == "meta" and out.shape == (M, N) and out.dtype == torch.float32
    assert quant_matmul.launches == before  # nothing launched
    nbytes = M * K * 2 + q.numel() + 4 * N + M * N * 4
    assert sink.calls == [("quant_matmul", 2 * M * K * N, nbytes)]
    # validated as on the card
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(torch.empty(K, M, dtype=torch.bfloat16, device="meta").t(), q, s, bits=bits)
    with pytest.raises(ValueError, match="bf16/f32"):
        quant_matmul(x.to(torch.float16), q, s, bits=bits)


def test_quant_matmul_cpu_reports_the_same_work():
    x, q, s = torch.randn(3, 64), torch.randint(-127, 128, (64, 16), dtype=torch.int8), torch.rand(16)
    with work.listening(_Sink()) as sink:
        quant_matmul(x, q, s, bits=8)
    assert sink.calls == [("quant_matmul", 2 * 3 * 64 * 16, 3 * 64 * 4 + 64 * 16 + 16 * 4 + 3 * 16 * 4)]


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 100), (False, 7)])
def test_flash_attention_meta_allocates_and_reports(causal, window):
    B, Hq, Hk, Sq, Sk, D = 2, 8, 2, 300, 300, 64
    q = torch.empty(B, Hq, Sq, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, Hk, Sk, D, dtype=torch.bfloat16, device="meta")
    with work.listening(_Sink()) as sink, dryrun.count_step(1) as c:
        out = flash_attention(q, k, k, causal=causal, window=window)
        assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "meta"
        # its operands and its output: no [B, H, Sq, Sk] scores, no repeated kv heads
        assert c.peak[0] == (2 * q.numel() + k.numel()) * 2
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Sk)[None]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= qp - kp < window
    assert work.flash_pairs(Sq, Sk, causal, window) == int(ok.sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * 2
    assert sink.calls == [("flash_attention", 4 * B * Hq * D * int(ok.sum()), nbytes)]
    assert c.flops == sink.calls[0][1] and c.kernels["flash_attention"]["calls"] == 1
    with pytest.raises(ValueError, match="1 <= D"):
        flash_attention(*(torch.empty(1, 2, 8, 256, device="meta"),) * 3)


def test_flash_pairs_causal_4096_matches_the_bound():
    # PERF.md's bound of [1,32,4096,64] causal: 0.06950 ms at 989 TFLOP/s
    flops = 4 * 32 * 64 * work.flash_pairs(4096, 4096, True, None)
    assert flops / 989e12 * 1e3 == pytest.approx(0.06950, abs=5e-6)


def test_attend_chunked_takes_the_kernel_route_on_meta():
    q = torch.empty(1, 4096, 4, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 4096, 2, 64, dtype=torch.bfloat16, device="meta")
    pos = torch.arange(4096, device="meta")
    with work.listening(_Sink()) as sink:
        out = attn.attend_chunked(q, k, k, mask=attn.AttnMask(causal=True), q_positions=pos, k_positions=pos)
    assert out.shape == q.shape and [c[0] for c in sink.calls] == ["flash_attention"]


def test_production_mesh_on_meta():
    single, multi = make_production_mesh(device="meta"), make_production_mesh(multi_pod=True, device="meta")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert {d.type for d in single.flat + multi.flat} == {"meta"}
    if torch.cuda.device_count() < 256:
        with pytest.raises(RuntimeError, match="needs 256 devices"):
            make_production_mesh()
