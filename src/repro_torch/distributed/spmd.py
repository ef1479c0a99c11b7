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

:func:`count_collectives` records, while its block runs, one entry per
collective call, as one HLO instruction is one: XLA's op name, the full
tensor's bytes (the gathered side of a gather, the operand of a reduce, one
shard's block of an all-to-all) in the dtype as issued -- ``all_reduce``
adds 16-bit floats in f32 but sends them as issued -- and the group size.
The backward pass issues no call here, so each collective whose outputs
require grad also records its transpose when the first of their gradients
arrives: a gather's reduce-scatter, an all-reduce's all-reduce, an
all-to-all's inverse.  :meth:`Sharded.full` is recorded as ``full-gather``:
it brings a tensor whole to one device (the prefill and decode logits),
which XLA's partitioned step has no instruction for; it is costed as an
all-gather of its distinct blocks.  Placement (:func:`shard`, :func:`place`)
is not a collective and records nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Callable

import torch

from repro_torch.core.precision import QTensor, tree_map
from repro_torch.distributed.hlo_analysis import CollectiveStats, ring_wire_bytes
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
    "CollectiveRecorder",
    "count_collectives",
]


@dataclasses.dataclass
class CollectiveRecorder:
    """The collectives issued inside :func:`count_collectives`: ``entries``
    holds ``{"op", "bytes", "g", "backward"}`` per call.  ``hold``, where
    given, is told which shards hold each collective's outputs (``hold(t,
    shards)``), for a counter of the shards' live bytes; with it, the
    members of an all-reduce on a mesh that repeats a device get their own
    copies of the sum, as members on distinct cards do."""

    entries: list = dataclasses.field(default_factory=list)
    hold: Callable | None = None

    def record(self, op: str, nbytes: int, g: int, backward: bool = False) -> None:
        self.entries.append({"op": op, "bytes": int(nbytes), "g": int(g), "backward": backward})

    def stats(self, backward: bool | None = None) -> CollectiveStats:
        """:class:`~.hlo_analysis.CollectiveStats` of the entries (only the
        forward or backward ones where ``backward`` says so), each costed by
        :func:`~.hlo_analysis.ring_wire_bytes`."""
        by_op: dict[str, dict] = {}
        total = 0.0
        for e in self.entries:
            if backward is not None and e["backward"] != backward:
                continue
            wire = ring_wire_bytes(_COSTED_AS.get(e["op"], e["op"]), e["bytes"], e["g"])
            total += wire
            rec = by_op.setdefault(e["op"], {"count": 0, "wire_bytes": 0.0})
            rec["count"] += 1
            rec["wire_bytes"] += wire
        return CollectiveStats(total, by_op, sum(r["count"] for r in by_op.values()))

    def issued(self, op: str, nbytes: int, g: int, xs: list, outs: list, transpose: str) -> None:
        """One collective ``op`` from the per-shard inputs ``xs`` to the
        outputs ``outs`` (shard ``i`` holds ``outs[i]``); its backward is
        ``transpose``, recorded once when the first of the outputs'
        gradients arrives."""
        self.record(op, nbytes, g)
        if self.hold is not None:
            for i, t in enumerate(outs):
                self.hold(t, (i,))
        if not torch.is_grad_enabled():
            return
        fired = []

        def transposed(grad):
            if not fired:
                fired.append(True)
                self.record(transpose, nbytes, g, backward=True)

        for t in {id(t): t for t in outs if t.requires_grad}.values():
            t.register_hook(transposed)
        if self.hold is None:
            return
        # the gradient the backward delivers to each input arrives as that
        # shard's own copy, as on distinct cards (where a mesh repeats a
        # device, the backward of a sum hands every member one tensor)
        seen = set()
        for k, x in enumerate(xs):
            if x.requires_grad and id(x) not in seen:
                seen.add(id(x))
                x.register_hook(lambda grad, k=k: self._arrived(grad, k))

    def _arrived(self, grad: torch.Tensor, k: int) -> torch.Tensor:
        grad = grad.clone()
        self.hold(grad, (k,))
        return grad


# ops recorded under names of their own, costed as an XLA collective
_COSTED_AS = {"full-gather": "all-gather"}

# the recorders of the open count_collectives blocks, innermost last.  The
# process's, not a context variable: a CUDA backward runs on autograd's
# device threads, and ``checkpoint`` recomputes its forward (and its
# gathers) there
_ACTIVE: list[CollectiveRecorder] = []


def _recorder() -> CollectiveRecorder | None:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def count_collectives(hold: Callable | None = None):
    """Record every collective issued inside the block (and the backward
    collectives of those whose gradients arrive later); yields the
    :class:`CollectiveRecorder`."""
    rec = CollectiveRecorder(hold=hold)
    _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        _ACTIVE.remove(rec)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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
        rec = _recorder()
        if rec is not None and len(seen) > 1:
            rec.record("full-gather", _nbytes(out), len(seen))
            if rec.hold is not None:
                rec.hold(out, (0,))
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
    rec = _recorder()
    if rec is not None and rec.hold is not None:
        for i, t in enumerate(shards):
            rec.hold(t, (i,))
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
    g = mesh.axis_size(axes)
    rec = _recorder()
    if rec is not None and g > 1:
        rec.issued("all-gather", _nbytes(out[0]), g, xs, out, "reduce-scatter")
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
    rec = _recorder()
    if rec is not None:
        rec.issued("all-to-all", _nbytes(xs[0]), n, xs, out, "all-to-all")
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
    rec = _recorder()
    # a memory counter attributes each member's sum to it: where the mesh
    # repeats a device, give every member its own copy, as distinct cards hold
    distinct = rec is not None and rec.hold is not None
    out = [None] * mesh.size
    for members in groups.values():
        dev, dt = xs[members[0]].device, xs[members[0]].dtype
        wide = dt in (torch.bfloat16, torch.float16) and op == "sum"
        acc = xs[members[0]].to(torch.float32) if wide else xs[members[0]]
        for k in members[1:]:
            y = xs[k].to(dev)
            acc = acc + (y.to(torch.float32) if wide else y) if op == "sum" else torch.maximum(acc, y)
        acc = acc.to(dt)
        for j, k in enumerate(members):
            out[k] = acc.to(mesh.flat[k], copy=distinct and j > 0)
    if rec is not None:
        rec.issued("all-reduce", _nbytes(xs[0]), mesh.axis_size(axes), xs, out, "all-reduce")
    return out
