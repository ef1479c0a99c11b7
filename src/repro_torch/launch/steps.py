"""Step builders: the train / prefill / decode steps of an architecture.

Port of ``repro/launch/steps.py``, shared by the training loop
(``train/loop.py``, ``launch/train.py``) and the serving checks.  JAX
returns jit-compiled steps with shardings and donated buffers; here a step
is a plain function that runs eagerly on the device its tensors live on,
and a :class:`StepBundle` carries it with its argument templates.  There is
no ``StepBundle.lower``: nothing is traced or compiled.

The train step takes over the state it is given, as JAX's donation does:
the parameter tree's leaves and the optimizer state's lists are rebound to
the new tensors one leaf at a time, so the old state is released as the
new one is made and a 1.6 B-parameter model never holds two copies of its
weights and moments.  Pass copies to keep the old state.  The optimizer
works on flat lists in ``models/common.py::tree_leaves`` order.

A mesh naming more than one distinct device is refused: JAX's FSDP over
its mesh has no port yet (ROADMAP Queue 1 #5).  JAX's knobs for its
sharded layouts -- ``bf16_gather`` (cast before the FSDP gathers) and
``shard_cache_seq`` (the cache's sequence over the data axis) -- have no
counterpart on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch._device import full_f32_matmul
from repro_torch.core.precision import PrecisionPolicy, QTensor, tree_map
from repro_torch.core.shard import DeviceMesh
from repro_torch.models.common import tree_unflatten
from repro_torch.models.registry import Arch, ShapeSpec
from repro_torch.train import optimizer as opt_lib

__all__ = ["StepBundle", "build_train_step", "build_prefill_step", "build_decode_step"]

_MULTI_DEVICE = (
    "{what} over {n} devices is not ported yet: JAX shards it over its mesh "
    "(FSDP / TP), the port runs one device (ROADMAP Queue 1 #5)"
)


@dataclasses.dataclass
class StepBundle:
    """A step function plus the templates of its arguments.

    ``jitted`` keeps JAX's field name; the function runs eagerly.
    ``abstract_args`` holds ``{name: (shape, dtype)}`` templates (a
    quantized leaf as a :class:`QTensor` of such pairs); the optimizer
    state's is ``None``, since its lists follow the parameters.
    """

    jitted: Callable
    abstract_args: tuple
    name: str


def check_one_device(mesh: DeviceMesh | None, what: str) -> None:
    """Refuse a mesh that names more than one distinct device."""
    if mesh is not None and len(set(mesh.devices)) > 1:
        raise NotImplementedError(_MULTI_DEVICE.format(what=what, n=len(set(mesh.devices))))


def _slots(tree):
    """``(dict, key)`` of every leaf of a nested-dict tree, in ``tree_leaves`` order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _slots(tree[k])
        else:
            yield tree, k


def build_train_step(
    arch: Arch,
    shape: ShapeSpec,
    mesh: DeviceMesh | None = None,
    cfg=None,
    *,
    lr: float = 3e-4,
    grad_clip: float = 1.0,
    optimizer: opt_lib.Optimizer | None = None,
    loss_fn: Callable | None = None,
) -> StepBundle:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    Loss and gradients (``torch.autograd.grad`` of ``loss_fn``), global-norm
    clipping, then the optimizer's update and ``apply_updates`` leaf by
    leaf -- the same functions and arithmetic as the whole-list calls, so
    the step equals JAX's to float rounding.  ``metrics`` are the loss
    function's (``ce``, ``aux``) plus ``loss`` and ``grad_norm``, tensors on
    the device.  Float32 products run without TF32 whatever the caller set.
    """
    check_one_device(mesh, "build_train_step")
    cfg = cfg or arch.config
    loss_fn = loss_fn or arch.loss_fn(cfg)
    optimizer = optimizer or opt_lib.adamw(lr)

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

    abs_params = arch.abstract_params(cfg)
    abs_batch = arch.input_template(shape, cfg)
    return StepBundle(train_step, (abs_params, None, abs_batch), f"train:{arch.name}:{shape.name}")


def _serve_params(arch: Arch, cfg, quant: PrecisionPolicy | None, serve_optimized: bool):
    """The serving side's parameter template: the training layout (f32), or
    bf16 float leaves with ``serve_optimized``; a leaf ``quant`` quantizes
    (2-D or stacked 3-D) as a QTensor of its int8 payload and f32 scale."""
    abs_params = arch.abstract_params(cfg)
    if serve_optimized:
        abs_params = tree_map(
            lambda _, s: (s[0], torch.bfloat16) if s[1].is_floating_point else s, abs_params
        )
    if quant is None:
        return abs_params

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

    return tree_map(q, abs_params)


def build_prefill_step(
    arch: Arch, shape: ShapeSpec, mesh: DeviceMesh | None = None, cfg=None, *,
    quant: PrecisionPolicy | None = None, serve_optimized: bool = False,
) -> StepBundle:
    """``prefill(params, batch) -> (logits, caches)``; ``params`` quantized
    by the caller where ``quant`` is given (its template says so)."""
    check_one_device(mesh, "build_prefill_step")
    cfg = cfg or arch.config
    abs_params = _serve_params(arch, cfg, quant, serve_optimized)
    abs_batch = arch.input_template(shape, cfg)
    return StepBundle(
        arch.prefill_fn(cfg), (abs_params, abs_batch), f"prefill:{arch.name}:{shape.name}"
    )


def build_decode_step(
    arch: Arch,
    shape: ShapeSpec,
    mesh: DeviceMesh | None = None,
    cfg=None,
    *,
    quant: PrecisionPolicy | None = None,
    serve_optimized: bool = False,
) -> StepBundle:
    """``decode(params, caches, batch) -> (logits, caches)``: one new token
    against a ``seq_len``-deep cache, written in place (JAX donates it)."""
    check_one_device(mesh, "build_decode_step")
    cfg = cfg or arch.config
    abs_params = _serve_params(arch, cfg, quant, serve_optimized)
    abs_cache = arch.cache_abstract(shape, cfg)
    abs_batch = arch.input_template(shape, cfg)
    return StepBundle(
        arch.decode_fn(cfg), (abs_params, abs_cache, abs_batch), f"decode:{arch.name}:{shape.name}"
    )

