"""Parameter templates, norms and init helpers shared by the LM architectures.

Port of ``repro/models/common.py``.  A *template* is a nested dict whose
leaves are :class:`ParamSpec` -- (shape, dtype, logical axes, init, scale)
-- from which aligned trees derive:

* ``abstract(template)``       -> ``(shape, dtype)`` leaves
* ``materialize(gen, t)``      -> initialised tensors from a ``torch.Generator``
* ``shardings(mesh, t)``       -> :class:`~repro_torch.distributed.sharding.NamedSharding` leaves
* ``partition_specs(mesh, t)`` -> their :class:`~repro_torch.distributed.sharding.P`

Sharding vocabulary (logical -> mesh axes), JAX's:
  "fsdp"  -> the data axis (a pod axis stays replicated; gradients sum over it)
  "tp"    -> the model axis (megatron column/row pairs, head/expert sharding)
Batch dims of activations shard over ("pod", "data") when the pod axis exists.
JAX's ``scan`` / ``unroll_scans`` serve its lower-and-compile dry run
(XLA's cost analysis counts a while body once); they are not ported: the
port's loops are Python loops, and its dry run (``launch/dryrun.py``)
counts every trip of one full-depth pass (ROADMAP, API differences).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.precision import QTensor, tree_map
from repro_torch.distributed.sharding import Mesh, NamedSharding, P

__all__ = [
    "FSDP",
    "TP",
    "ParamSpec",
    "dense",
    "scalar_array",
    "abstract",
    "logical_to_mesh",
    "partition_spec",
    "partition_specs",
    "shardings",
    "DTypePolicy",
    "materialize",
    "params_from_numpy",
    "tree_leaves",
    "tree_unflatten",
    "unstack",
    "rms_norm",
    "layer_norm",
]


# Logical axis names used inside templates; resolved against the mesh later.
FSDP = "fsdp"
TP = "tp"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    logical: tuple[str | None, ...] = ()
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # stddev; default 1/sqrt(fan_in)

    def __post_init__(self):
        if self.logical and len(self.logical) != len(self.shape):
            raise ValueError(f"logical axes {self.logical} do not match shape {self.shape}")


def dense(*shape, logical=(), init="normal", scale=None, dtype=torch.float32) -> ParamSpec:
    return ParamSpec(
        tuple(shape), dtype, tuple(logical) if logical else (None,) * len(shape), init, scale
    )


def scalar_array(value_init="zeros", dtype=torch.float32) -> ParamSpec:
    return ParamSpec((), dtype, (), value_init)


def abstract(template):
    """``(shape, dtype)`` of every leaf (JAX's ``ShapeDtypeStruct`` leaves)."""
    return tree_map(lambda _, s: (s.shape, s.dtype), template)


def _fan_in(shape: tuple[int, ...]) -> int:
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    # convention: last axis is the output features; everything else is fan-in
    return int(np.prod(shape[:-1]))


def tree_leaves(tree, path: str = ""):
    """(path, leaf) pairs of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], f"{path}/{k}" if path else str(k)))
        return out
    return [(path, tree)]


def tree_unflatten(like, leaves):
    """A nested dict shaped as ``like`` whose leaves are ``leaves``, taken in
    :func:`tree_leaves` order (the inverse of flattening ``like``)."""
    it = iter(leaves)
    values = {p: next(it) for p, _ in tree_leaves(like)}
    return tree_map(lambda p, _: values[p], like)


def unstack(tree, n: int) -> list:
    """Each of the ``n`` layers' (or repeat groups') slices of every stacked
    leaf of ``tree`` (views, no copy; a stacked :class:`QTensor` by
    :meth:`~QTensor.layer`): the port's counterpart of JAX's ``scan`` over
    stacked parameters and caches.

    Each leaf is unbound once: the backward of ``unbind`` stacks the
    layers' gradients into the leaf's in one pass, where indexing ``t[g]``
    per layer would give each layer a zero-filled gradient of the whole
    stacked leaf to add up (JAX's scan writes each iteration's gradient
    into its slice)."""
    split = tree_map(
        lambda _, t: [t.layer(g) for g in range(n)] if isinstance(t, QTensor) else t.unbind(0), tree
    )
    return [tree_map(lambda _, s: s[g], split) for g in range(n)]


def materialize(gen: torch.Generator, template, device=None):
    """Initialise every leaf of ``template`` on ``device`` (default: the
    generator's), drawing normals from ``gen`` in sorted-path order."""
    device = torch.device(device) if device is not None else gen.device

    def make(_, s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        std = s.scale if s.scale is not None else 1.0 / math.sqrt(max(1, _fan_in(s.shape)))
        z = torch.randn(s.shape, generator=gen, dtype=torch.float32, device=gen.device)
        return (z * std).to(device=device, dtype=s.dtype)

    # visit leaves in sorted-path order so the draw sequence does not depend
    # on the template's dict insertion order
    values = {p: make(p, s) for p, s in tree_leaves(template)}
    return tree_map(lambda p, _: values[p], template)


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy (arrays from JAX are read-only)
    if a.dtype.name == "bfloat16":  # numpy has no native bf16: widen exactly, then narrow
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device="cuda"):
    """Carry a parameter tree of numpy arrays (e.g. a JAX tree after
    ``np.asarray``) onto ``device`` (``cuda`` unless the caller asks for the
    CPU).  Quantized leaves -- any object with
    ``q``, ``scale``, ``bits`` and ``shape`` -- become :class:`QTensor`."""
    device = resolve_device(device)

    def carry(tree):
        if isinstance(tree, dict):
            return {k: carry(v) for k, v in tree.items()}
        if all(hasattr(tree, a) for a in ("q", "scale", "bits", "shape")):
            return QTensor(
                q=_tensor_from_numpy(tree.q, device),
                scale=_tensor_from_numpy(tree.scale, device),
                bits=int(tree.bits),
                shape=tuple(tree.shape),
            )
        return _tensor_from_numpy(tree, device)

    return carry(tree)


def logical_to_mesh(mesh: Mesh) -> dict[str, str | tuple[str, ...] | None]:
    """Map logical axis names onto whatever axes the mesh actually has."""
    names = mesh.axis_names
    return {
        FSDP: "data" if "data" in names else None,
        TP: "model" if "model" in names else None,
        "batch": tuple(n for n in ("pod", "data") if n in names) or None,
    }


def partition_spec(spec: ParamSpec, table, mesh: Mesh | None = None) -> P:
    """Resolve logical axes to mesh axes, dropping any assignment whose
    dimension is not divisible by the mesh axis (e.g. qwen2-moe's 60
    experts over a 16-way model axis fall back to replication on that dim)."""
    axes = []
    logical = spec.logical or (None,) * len(spec.shape)
    for dim, a in zip(spec.shape, logical):
        name = table.get(a) if a else None
        if name is not None and mesh is not None:
            names = name if isinstance(name, tuple) else (name,)
            if dim % math.prod(mesh.shape[n] for n in names):
                name = None
        axes.append(name)
    return P(*axes)


def partition_specs(mesh: Mesh, template):
    table = logical_to_mesh(mesh)
    return tree_map(lambda _, s: partition_spec(s, table, mesh), template)


def shardings(mesh: Mesh, template):
    return tree_map(lambda _, s: NamedSharding(mesh, s), partition_specs(mesh, template))


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    params: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16

    def cast_in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, *, plus_one: bool = False):
    """RMSNorm in f32 (numerics match the reference implementations)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    if plus_one:  # gemma convention: weight stored as (gamma - 1)
        w = w + 1.0
    return (normed * w).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)
