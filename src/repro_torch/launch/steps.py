"""Step builders: the train / prefill / decode steps of an architecture.

Port of ``repro/launch/steps.py``, shared by the training loop
(``train/loop.py``, ``launch/train.py``) and the serving checks.  JAX
returns jit-compiled steps with shardings and donated buffers; here a step
is a plain function that runs eagerly on the devices its tensors live on,
and a :class:`StepBundle` carries it with its argument templates and, on a
mesh, their partition specs.  There is no ``StepBundle.lower``: nothing is
traced or compiled.

The train step takes over the state it is given, as JAX's donation does:
the parameter tree's leaves and the optimizer state's lists are rebound to
the new tensors one leaf at a time, so the old state is released as the
new one is made and a 1.6 B-parameter model never holds two copies of its
weights and moments.  Pass copies to keep the old state.  The optimizer
works on flat lists in ``models/common.py::tree_leaves`` order.

``mesh``: ``None`` or a one-shard mesh runs on the device the tensors live
on.  A named :class:`~repro_torch.distributed.sharding.Mesh` of several
shards (``launch/mesh.py``; a ``core/shard.py`` ``DeviceMesh`` counts as
(n, 1) over ("data", "model")) runs every architecture sharded -- the
dense, MoE, SSM, hybrid and VLM families of the decoder LM
(``models/sharded.py``, ``sharded_moe.py``, ``sharded_ssm.py``) and Whisper
(``models/sharded_whisper.py``): parameters and both AdamW moments placed
by ``param_pspecs`` (serving: ``serve_optimized``'s TP-only specs and
``_quant_pspecs``), batches by ``input_pspecs`` and caches by
``cache_pspecs`` (``shard_cache_seq``: their sequence over ``data``).  A
leaf passed whole is placed on entry and the caller's tree is rebound to
the placed leaf (JAX's ``in_shardings`` with donation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch._device import full_f32_matmul
from repro_torch.core.precision import PrecisionPolicy, QTensor, tree_map
from repro_torch.core.shard import DeviceMesh
from repro_torch.distributed.sharding import Mesh, NamedSharding, P, axis_names_of
from repro_torch.distributed.spmd import Sharded, all_reduce, place
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.models.registry import Arch, ShapeSpec
from repro_torch.train import optimizer as opt_lib

__all__ = [
    "StepBundle",
    "build_train_step",
    "build_prefill_step",
    "build_decode_step",
    "init_opt_state",
    "mesh_value_and_grad",
]


@dataclasses.dataclass
class StepBundle:
    """A step function plus the templates of its arguments.

    ``jitted`` keeps JAX's field name; the function runs eagerly.
    ``abstract_args`` holds ``{name: (shape, dtype)}`` templates (a
    quantized leaf as a :class:`QTensor` of such pairs); the optimizer
    state's is ``None``, since its lists follow the parameters.  On a mesh,
    ``specs`` holds the partition specs of the same arguments (the
    optimizer state's: the parameters', for each moment) and ``mesh`` the
    mesh; both are ``None`` on one device.
    """

    jitted: Callable
    abstract_args: tuple
    name: str
    specs: tuple | None = None
    mesh: Mesh | None = None


def as_mesh(mesh) -> Mesh | None:
    """``None`` for one shard (the one-device code), else a named mesh."""
    if isinstance(mesh, DeviceMesh):
        mesh = make_mesh((mesh.n_shards, 1), mesh.devices)
    return mesh if mesh is not None and mesh.size > 1 else None


def _slots(tree):
    """``(dict, key)`` of every leaf of a nested-dict tree, in ``tree_leaves`` order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _slots(tree[k])
        else:
            yield tree, k


def _place_into(tree: dict, specs, mesh: Mesh) -> None:
    """Rebind every leaf of ``tree`` to its placement by ``specs``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _place_into(v, specs[k], mesh)
        elif v is not None:
            tree[k] = place(v, specs[k], mesh)


def _place_batch(batch: dict, specs: dict, mesh: Mesh) -> dict:
    return {k: place(v, specs[k], mesh) for k, v in batch.items()}


def _bf16(_, p):
    """A floating leaf cast to bf16 (on a mesh: each shard, before any gather)."""
    if isinstance(p, Sharded):
        return p.map(lambda t: t.to(torch.bfloat16)) if p.dtype.is_floating_point else p
    return p.to(torch.bfloat16) if p.is_floating_point() else p


def _replica_axes(mesh: Mesh, spec: P) -> tuple[str, ...]:
    """The mesh axes a leaf is replicated over (its gradient sums over them)."""
    used = {a for e in spec for a in axis_names_of(e)}
    return tuple(a for a in mesh.axis_names if a not in used)


def build_train_step(
    arch: Arch,
    shape: ShapeSpec,
    mesh=None,
    cfg=None,
    *,
    lr: float = 3e-4,
    grad_clip: float = 1.0,
    optimizer: opt_lib.Optimizer | None = None,
    loss_fn: Callable | None = None,
    bf16_gather: bool = False,
) -> StepBundle:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    Loss and gradients (``torch.autograd.grad`` of ``loss_fn``), global-norm
    clipping, then the optimizer's update and ``apply_updates`` leaf by
    leaf -- the same functions and arithmetic as the whole-list calls, so
    the step equals JAX's to float rounding.  ``metrics`` are the loss
    function's (``ce``, ``aux``) plus ``loss`` and ``grad_norm``, tensors on
    the (first) device.  Float32 products run without TF32 whatever the
    caller set.  ``bf16_gather`` casts every floating leaf to bf16 at the
    start of the loss, JAX's single cast site: on a mesh each shard is cast
    before its FSDP gather, halving the gathered bytes.

    On a mesh each leaf's shards get their gradients from autograd (the
    FSDP gathers' backward reduce-scatters them); a leaf replicated over an
    axis sums its replicas' gradients over that axis, its norm counts once
    in the clip, and every replica takes the same update.
    """
    mesh = as_mesh(mesh)
    cfg = cfg or arch.config
    loss_fn = loss_fn or arch.loss_fn(cfg)
    optimizer = optimizer or opt_lib.adamw(lr)
    abs_params = arch.abstract_params(cfg)
    abs_batch = arch.input_template(shape, cfg)
    name = f"train:{arch.name}:{shape.name}"
    if bf16_gather:
        inner = loss_fn

        def loss_fn(params, batch):  # noqa: F811
            return inner(tree_map(_bf16, params), batch)

    if mesh is None:
        return StepBundle(_one_device_step(loss_fn, optimizer, grad_clip), (abs_params, None, abs_batch), name)

    p_specs = arch.param_pspecs(mesh, cfg)
    b_specs = arch.input_pspecs(mesh, shape, cfg)
    leaf_specs = [s for _, s in tree_leaves(p_specs)]

    def train_step(params, opt_state, batch):
        _place_into(params, p_specs, mesh)
        fields = opt_state[1:]
        for f in fields:
            f[:] = [place(t, s, mesh) for t, s in zip(f, leaf_specs)]
        slots = list(_slots(params))
        with full_f32_matmul():
            loss, metrics, grads = mesh_value_and_grad(
                loss_fn, params, _place_batch(batch, b_specs, mesh)
            )
            with torch.no_grad():
                gnorm = _global_norm(grads)
                scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
                steps, scales, new_step = {}, {}, None
                for j, (d, k) in enumerate(slots):
                    x, g = d[k], grads[j]
                    per_shard = []
                    for i, dev in enumerate(mesh.flat):
                        if dev not in steps:
                            steps[dev], scales[dev] = opt_state.step.to(dev), scale.to(dev)
                        one = type(opt_state)(steps[dev], *([f[j].shards[i]] for f in fields))
                        upd, new = optimizer.update([g.shards[i] * scales[dev]], one, [x.shards[i]])
                        new_step = new.step if new_step is None else new_step
                        p_new = opt_lib.apply_updates([x.shards[i]], upd)[0]
                        per_shard.append((p_new, *(nf[0] for nf in new[1:])))
                    grads[j] = None
                    cols = list(zip(*per_shard))
                    d[k] = Sharded(list(cols[0]), mesh, x.spec, x.shape)
                    for f, col in zip(fields, cols[1:]):
                        f[j] = Sharded(list(col), mesh, x.spec, x.shape)
        metrics.update(loss=loss, grad_norm=gnorm)
        return params, type(opt_state)(new_step, *fields), metrics

    specs = (p_specs, p_specs, b_specs)
    return StepBundle(train_step, (abs_params, None, abs_batch), name, specs, mesh)


def init_opt_state(optimizer, params):
    """``optimizer.init`` over a parameter tree's leaves (``tree_leaves``
    order); sharded leaves are initialised shard by shard, so each moment is
    laid out as its leaf and nothing is made whole."""
    leaves = [t for _, t in tree_leaves(params)]
    if not any(isinstance(x, Sharded) for x in leaves):
        return optimizer.init(leaves)
    mesh = leaves[0].mesh
    per = [optimizer.init([x.shards[i] for x in leaves]) for i in range(mesh.size)]
    fields = [
        [Sharded([per[i][f][j] for i in range(mesh.size)], mesh, x.spec, x.shape) for j, x in enumerate(leaves)]
        for f in range(1, len(per[0]))
    ]
    return type(per[0])(per[0].step, *fields)


def mesh_value_and_grad(loss_fn, params, batch):
    """``(loss, metrics, grads)`` of ``loss_fn`` at sharded ``params``
    (detached): ``grads`` holds a :class:`Sharded` per leaf in
    ``tree_leaves`` order, laid out as the leaf, each shard's gradient the
    sum over the leaf's replicas (so every replica holds the whole
    gradient of its block).  Float32 products at the caller's precision."""
    leaves = [x.map(lambda t: t.detach().requires_grad_(True)) for _, x in tree_leaves(params)]
    diff = tree_unflatten(params, leaves)
    with torch.enable_grad():
        loss, metrics = loss_fn(diff, batch)
        flat = [t for x in leaves for t in x.shards]
        flat_grads = iter(torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True))
    del diff, flat
    grads = []
    with torch.no_grad():
        for x in leaves:
            gs = [next(flat_grads) for _ in x.shards]
            gs = all_reduce(gs, x.mesh, _replica_axes(x.mesh, x.spec))
            grads.append(Sharded(gs, x.mesh, x.spec, x.shape))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def _global_norm(grads: list) -> torch.Tensor:
    """The L2 norm of sharded gradients, each block counted once (on the
    first shard that holds it), summed in shard order on the first device."""
    dev0 = grads[0].mesh.flat[0]
    sq = torch.zeros((), dtype=torch.float32, device=dev0)
    for g in grads:
        rep = _replica_axes(g.mesh, g.spec)
        for i, t in enumerate(g.shards):
            if all(g.mesh.coord(i)[a] == 0 for a in rep):
                sq = sq + torch.square(t.to(torch.float32)).sum().to(dev0)
    return torch.sqrt(sq)


def _one_device_step(loss_fn, optimizer, grad_clip):
    def train_step(params, opt_state, batch):
        slots = list(_slots(params))
        leaves = [d[k].detach().requires_grad_(True) for d, k in slots]
        diff = tree_unflatten(params, leaves)  # the same tree, its leaves requiring grad
        with full_f32_matmul():
            with torch.enable_grad():
                loss, metrics = loss_fn(diff, batch)
                grads = list(torch.autograd.grad(loss, leaves))
            del diff, leaves
            with torch.no_grad():
                grads, gnorm = opt_lib.clip_by_global_norm(grads, grad_clip)
                fields = opt_state[1:]
                step = opt_state.step
                for i, (d, k) in enumerate(slots):
                    one = type(opt_state)(opt_state.step, *([f[i]] for f in fields))
                    upd, new = optimizer.update([grads[i]], one, [d[k]])
                    grads[i] = None
                    for f, nf in zip(fields, new[1:]):
                        f[i] = nf[0]
                    d[k] = opt_lib.apply_updates([d[k]], upd)[0]
                    step = new.step
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm)
        return params, type(opt_state)(step, *fields), metrics

    return train_step


def _serve_params(arch: Arch, cfg, quant: PrecisionPolicy | None, serve_optimized: bool, mesh):
    """The serving side's parameter template and, on a mesh, its specs.

    The training layout (f32; FSDP + TP), or with ``serve_optimized`` bf16
    float leaves sharded TP-only (replicated over data: a batch-sharded
    decode then gathers no parameter); a leaf ``quant`` quantizes (2-D or
    stacked 3-D) as a QTensor of its int8 payload and f32 scale, whose
    specs ``_quant_pspecs`` aligns."""
    abs_params = arch.abstract_params(cfg)
    p_specs = arch.param_pspecs(mesh, cfg) if mesh is not None else None
    if serve_optimized:
        abs_params = tree_map(
            lambda _, s: (s[0], torch.bfloat16) if s[1].is_floating_point else s, abs_params
        )
        if p_specs is not None:
            p_specs = tree_map(lambda _, s: P(*(a if a == "model" else None for a in s)), p_specs)
    if quant is not None:

        def q(path, s):
            shape, _ = s
            bits = quant.bits_for(path)
            if bits is None or bits >= 16 or len(shape) not in (2, 3):
                return s
            n = shape[-1] // 2 if bits == 4 else shape[-1]
            return QTensor(
                q=((*shape[:-1], n), torch.int8), scale=((*shape[:-2], shape[-1]), torch.float32),
                bits=bits, shape=tuple(shape),
            )

        abs_params = tree_map(q, abs_params)
    if p_specs is not None:
        p_specs = _quant_pspecs(p_specs, abs_params)
    return abs_params, p_specs


def _quant_pspecs(p_specs, abs_params):
    """Align a spec tree with a (possibly quantized) template: a QTensor
    leaf's ``q`` keeps the weight's spec, its per-column ``scale`` takes the
    spec's last axis."""
    if isinstance(p_specs, dict):
        return {k: _quant_pspecs(v, abs_params[k]) for k, v in p_specs.items()}
    leaf = abs_params
    if isinstance(leaf, QTensor):
        last = p_specs[-1] if len(p_specs) else None
        lead = tuple(p_specs[:-1]) if len(p_specs) else ()
        n_scale = len(leaf.scale[0])
        return QTensor(
            q=P(*lead, last), scale=P(*((None,) * (n_scale - 1)), last), bits=leaf.bits,
            shape=leaf.shape,
        )
    return p_specs


def _serving(arch, mesh, cfg, quant, serve_optimized):
    mesh = as_mesh(mesh)
    cfg = cfg or arch.config
    abs_params, p_specs = _serve_params(arch, cfg, quant, serve_optimized, mesh)
    return mesh, cfg, abs_params, p_specs


def build_prefill_step(
    arch: Arch, shape: ShapeSpec, mesh=None, cfg=None, *,
    quant: PrecisionPolicy | None = None, serve_optimized: bool = False,
) -> StepBundle:
    """``prefill(params, batch) -> (logits, caches)``; ``params`` quantized
    by the caller where ``quant`` is given (its template says so).  On a
    mesh the logits come back whole on the mesh's first device and the
    caches sharded by ``cache_pspecs``."""
    mesh, cfg, abs_params, p_specs = _serving(arch, mesh, cfg, quant, serve_optimized)
    abs_batch = arch.input_template(shape, cfg)
    name = f"prefill:{arch.name}:{shape.name}"
    prefill = arch.prefill_fn(cfg)
    if mesh is None:
        return StepBundle(prefill, (abs_params, abs_batch), name)
    b_specs = arch.input_pspecs(mesh, shape, cfg)

    def step(params, batch):
        _place_into(params, p_specs, mesh)
        return prefill(params, _place_batch(batch, b_specs, mesh))

    return StepBundle(step, (abs_params, abs_batch), name, (p_specs, b_specs), mesh)


def build_decode_step(
    arch: Arch,
    shape: ShapeSpec,
    mesh=None,
    cfg=None,
    *,
    quant: PrecisionPolicy | None = None,
    shard_cache_seq: bool = False,
    serve_optimized: bool = False,
) -> StepBundle:
    """``decode(params, caches, batch) -> (logits, caches)``: one new token
    against a ``seq_len``-deep cache, written in place (JAX donates it).
    ``shard_cache_seq`` puts the KV caches' sequence over ``data`` (the
    long_500k layout, batch 1) and the attention takes its two-pass softmax
    over that axis (``models/sharded.py``); Whisper's cross cache takes it,
    its self cache does not, and SSM caches have no sequence.  It is a
    layout of several shards: on one device it changes nothing; where the
    batch already splits over ``data`` its spec names ``data`` twice and
    raises :class:`~repro_torch.distributed.sharding.DuplicateSpecError`,
    as JAX's does."""
    mesh, cfg, abs_params, p_specs = _serving(arch, mesh, cfg, quant, serve_optimized)
    abs_cache = arch.cache_abstract(shape, cfg)
    abs_batch = arch.input_template(shape, cfg)
    name = f"decode:{arch.name}:{shape.name}"
    decode = arch.decode_fn(cfg)
    if mesh is None:
        return StepBundle(decode, (abs_params, abs_cache, abs_batch), name)
    c_specs = arch.cache_pspecs(mesh, shape, cfg, shard_seq=shard_cache_seq)
    tree_map(lambda _, s: NamedSharding(mesh, s), c_specs)  # a duplicated axis raises here, as in JAX
    b_specs = arch.input_pspecs(mesh, shape, cfg)

    def step(params, caches, batch):
        _place_into(params, p_specs, mesh)
        _place_into(caches, c_specs, mesh)
        return decode(params, caches, _place_batch(batch, b_specs, mesh))

    return StepBundle(step, (abs_params, abs_cache, abs_batch), name, (p_specs, c_specs, b_specs), mesh)
