"""Sharded tensors and collectives: the port's counterpart of XLA's SPMD partitioner.

JAX runs one program over a named mesh and lets XLA partition it by the
specs of its inputs.  The port does the same from one Python process that
drives every shard (JAX's single controller): a :class:`Sharded` value
holds one tensor per shard of a :class:`~.sharding.Mesh`, in the mesh's
flat order, each the block its :class:`~.sharding.P` assigns to that shard
(replicated dimensions whole).  Replicas are distinct tensors, also where a
mesh repeats a device, so that writing one never writes another.

* :func:`shard` / :func:`shard_tree` place tensors (``jax.device_put(x,
  NamedSharding)``); :meth:`Sharded.full` / :func:`gather_tree` bring them
  back whole.
* :func:`reshard` moves a value to another spec: an all-gather over the
  axes it drops, a local slice for the axes it adds.
* :func:`all_reduce` sums (or takes the max) over mesh axes.
* :func:`all_to_all` exchanges blocks over a mesh axis (the MoE's tokens
  to their experts' owners and back).

Collectives are ordered copies (``Tensor.to``), concatenations and sums in
a fixed order (shard order along the reduced axes), so a run repeats bit
for bit and every member of a group gets the same bits.  Autograd runs
through them: the backward of a gather is a reduce-scatter of the
gradients, the backward of a sum copied to the group members is the sum
of their gradients broadcast back -- no backward is written by hand.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from repro_torch.core.precision import QTensor, tree_map
from repro_torch.distributed.sharding import Mesh, NamedSharding, P, axis_names_of

__all__ = [
    "Sharded",
    "shard",
    "place",
    "shard_tree",
    "gather_tree",
    "reshard",
    "all_reduce",
    "all_gather",
    "all_to_all",
    "local",
    "local_tree",
    "is_sharded",
]


@dataclasses.dataclass(eq=False)
class Sharded:
    """A global tensor of ``shape`` laid out on ``mesh`` by ``spec``:
    ``shards[i]`` is shard ``i``'s block, on ``mesh.flat[i]``."""

    shards: list
    mesh: Mesh
    spec: P
    shape: tuple[int, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    @classmethod
    def from_local(cls, shards, mesh: Mesh, spec: P) -> "Sharded":
        """Wrap per-shard blocks; the global shape follows from the spec."""
        spec = _full_spec(spec, shards[0].dim())
        shape = tuple(n * mesh.axis_size(e) for n, e in zip(shards[0].shape, spec))
        return cls(list(shards), mesh, spec, shape)

    def map(self, fn) -> "Sharded":
        """``fn`` applied to every block (an elementwise op keeps the layout)."""
        return Sharded([fn(t) for t in self.shards], self.mesh, self.spec, self.shape)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first), each
        block copied from the first shard that holds it."""
        device = torch.device(device) if device is not None else self.mesh.flat[0]
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for i, t in enumerate(self.shards):
            blocks = tuple(self.mesh.block_index(i, e) for e in self.spec)
            if blocks not in seen:
                seen.add(blocks)
                out[_slices(self.mesh, self.spec, self.shape, i)] = t.to(device)
        return out

    def unbind0(self) -> list["Sharded"]:
        """The slices along an unsharded leading axis (each block unbound
        once, so the backward stacks the slices' gradients in one pass)."""
        if self.spec[0] is not None:
            raise ValueError(f"unbind0: the leading axis is sharded ({self.spec})")
        parts = [t.unbind(0) for t in self.shards]
        spec = P(*self.spec[1:])
        return [
            Sharded([p[g] for p in parts], self.mesh, spec, self.shape[1:])
            for g in range(self.shape[0])
        ]


def is_sharded(tree) -> bool:
    """Whether any leaf of a nested-dict tree is :class:`Sharded` (or a
    :class:`QTensor` of sharded tensors)."""
    if isinstance(tree, dict):
        return any(is_sharded(v) for v in tree.values())
    return isinstance(tree, Sharded) or (isinstance(tree, QTensor) and isinstance(tree.q, Sharded))


def _full_spec(spec, ndim: int) -> P:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dimensions")
    return P(*spec, *(None,) * (ndim - len(spec)))


def _slices(mesh: Mesh, spec: P, shape, i: int) -> tuple[slice, ...]:
    out = []
    for n, e in zip(shape, spec):
        k = mesh.axis_size(e)
        b = mesh.block_index(i, e)
        out.append(slice(b * (n // k), (b + 1) * (n // k)))
    return tuple(out)


def shard(x: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """Place ``x`` on ``sharding``'s mesh: every shard gets its own copy of
    its block (``jax.device_put(x, sharding)``)."""
    mesh = sharding.mesh
    spec = _full_spec(sharding.spec, x.dim())
    for n, e in zip(x.shape, spec):
        if n % mesh.axis_size(e):
            raise ValueError(
                f"dimension {n} does not divide over mesh axes {e} "
                f"({mesh.axis_size(e)} blocks); spec {spec}, shape {tuple(x.shape)}"
            )
    shards = [
        x[_slices(mesh, spec, x.shape, i)].to(
            device=dev, copy=True, memory_format=torch.contiguous_format
        )
        for i, dev in enumerate(mesh.flat)
    ]
    return Sharded(shards, mesh, spec, tuple(x.shape))


def place(leaf, spec, mesh: Mesh):
    """One leaf (a tensor, :class:`Sharded` or :class:`QTensor`) laid out by
    ``spec`` on ``mesh``: placed, resharded, or as it is where it already is."""
    if leaf is None:
        return None
    if isinstance(leaf, QTensor):
        return QTensor(
            q=place(leaf.q, spec.q, mesh), scale=place(leaf.scale, spec.scale, mesh),
            bits=leaf.bits, shape=leaf.shape,
        )
    if isinstance(leaf, Sharded):
        if leaf.mesh == mesh:
            return reshard(leaf, spec)
        leaf = leaf.full()
    return shard(leaf, NamedSharding(mesh, spec))


def shard_tree(tree, specs, mesh: Mesh):
    """A nested-dict tree of tensors (or :class:`QTensor`) placed by the
    matching tree of specs (a quantized leaf's spec is a QTensor of two
    specs, ``_quant_pspecs``'s).  Leaves already on the mesh are resharded
    where their spec differs."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return place(tree, specs, mesh)


def gather_tree(tree, device=None):
    """Every :class:`Sharded` leaf (also inside a :class:`QTensor`) whole on
    ``device`` (default: its mesh's first device); other leaves as given."""

    def whole(_, leaf):
        if isinstance(leaf, Sharded):
            return leaf.full(device)
        if isinstance(leaf, QTensor) and isinstance(leaf.q, Sharded):
            return QTensor(leaf.q.full(device), leaf.scale.full(device), leaf.bits, leaf.shape)
        return leaf

    return tree_map(whole, tree)


def local(leaf, i: int):
    """Shard ``i``'s block of a leaf; a quantized leaf becomes a
    :class:`QTensor` of its local blocks.  Other leaves as given."""
    if isinstance(leaf, Sharded):
        return leaf.shards[i]
    if isinstance(leaf, QTensor) and isinstance(leaf.q, Sharded):
        q, s = leaf.q.shards[i], leaf.scale.shards[i]
        return QTensor(q=q, scale=s, bits=leaf.bits, shape=(*q.shape[:-1], s.shape[-1]))
    return leaf


def local_tree(tree, i: int):
    """Shard ``i``'s blocks of every leaf: the tree one shard computes with."""
    return tree_map(lambda _, leaf: local(leaf, i), tree)


def all_gather(xs: list, mesh: Mesh, axes, dim: int) -> list:
    """Concatenate the per-shard tensors ``xs`` along ``dim`` over the mesh
    ``axes``: every shard gets, in block order (row-major over ``axes``), the
    blocks held by the shards that differ from it only along those axes."""
    names = axis_names_of(axes)
    out = []
    for i, dev in enumerate(mesh.flat):
        c = mesh.coord(i)
        parts = [
            xs[mesh.index({**c, **dict(zip(names, combo))})].to(dev)
            for combo in itertools.product(*(range(mesh.shape[a]) for a in names))
        ]
        out.append(torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0])
    return out


def all_to_all(xs: list, mesh: Mesh, axis: str, split_dim: int, concat_dim: int) -> list:
    """Exchange blocks over the mesh ``axis`` (``jax.lax.all_to_all``): the
    shard at index ``j`` along ``axis`` gets, from every member ``k`` of its
    group in order, block ``j`` of ``xs[k]`` cut into ``n`` along
    ``split_dim``, concatenated along ``concat_dim``.  The same call with
    the two dims swapped is its inverse, and autograd's backward of the
    copies and the concatenation is that inverse exchange."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return list(xs)
    out = []
    for i, dev in enumerate(mesh.flat):
        c = mesh.coord(i)
        parts = []
        for k in range(n):
            src = xs[mesh.index({**c, axis: k})]
            size, rem = divmod(src.shape[split_dim], n)
            if rem:
                raise ValueError(f"all_to_all: dimension {src.shape[split_dim]} does not divide over {n}")
            parts.append(src.narrow(split_dim, c[axis] * size, size).to(dev))
        out.append(torch.cat(parts, dim=concat_dim))
    return out


def _gather_dim(x: Sharded, j: int) -> Sharded:
    """All-gather dimension ``j`` over the axes of its spec entry."""
    spec = P(*(None if d == j else e for d, e in enumerate(x.spec)))
    return Sharded(all_gather(x.shards, x.mesh, x.spec[j], j), x.mesh, spec, x.shape)


def _split_dim(x: Sharded, j: int, entry) -> Sharded:
    """Keep, on every shard, its block of the (replicated) dimension ``j``
    under spec ``entry`` -- a local slice, no communication."""
    mesh, n = x.mesh, x.shape[j]
    k = mesh.axis_size(entry)
    if n % k:
        raise ValueError(f"dimension {n} does not divide over mesh axes {entry}")
    out = [
        t.narrow(j, mesh.block_index(i, entry) * (n // k), n // k) for i, t in enumerate(x.shards)
    ]
    spec = P(*(entry if d == j else e for d, e in enumerate(x.spec)))
    return Sharded(out, mesh, spec, x.shape)


def reshard(x: Sharded, spec) -> Sharded:
    """``x`` laid out by ``spec`` on the same mesh: an all-gather of every
    dimension whose entry changes, then a local slice for the new entries."""
    spec = _full_spec(spec, x.ndim)
    for j, (old, new) in enumerate(zip(x.spec, spec)):
        if old is not None and old != new:
            x = _gather_dim(x, j)
    for j, (old, new) in enumerate(zip(x.spec, spec)):
        if old != new:
            x = _split_dim(x, j, new)
    return x


def all_reduce(xs: list, mesh: Mesh, axes: tuple[str, ...], op: str = "sum") -> list:
    """Reduce the per-shard tensors ``xs`` over the mesh ``axes``.

    Each group (the shards that differ only along ``axes``) combines its
    members in shard order on the group's first device -- sums of 16-bit
    floats in float32, rounded once -- and every member gets a copy.  Axes
    the mesh lacks, or of size 1, reduce nothing.
    """
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not axes:
        return list(xs)
    groups: dict[tuple, list[int]] = {}
    for i in range(mesh.size):
        c = mesh.coord(i)
        groups.setdefault(tuple(v for a, v in c.items() if a not in axes), []).append(i)
    out = [None] * mesh.size
    for members in groups.values():
        dev, dt = xs[members[0]].device, xs[members[0]].dtype
        wide = dt in (torch.bfloat16, torch.float16) and op == "sum"
        acc = xs[members[0]].to(torch.float32) if wide else xs[members[0]]
        for k in members[1:]:
            y = xs[k].to(dev)
            acc = acc + (y.to(torch.float32) if wide else y) if op == "sum" else torch.maximum(acc, y)
        acc = acc.to(dt)
        for k in members:
            out[k] = acc.to(mesh.flat[k])
    return out
