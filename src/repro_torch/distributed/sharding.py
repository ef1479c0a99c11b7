"""Named meshes, partition specs and activation-sharding rules.

Port of ``repro/distributed/sharding.py``, with the port's own counterparts
of ``jax.sharding.Mesh``, ``PartitionSpec`` and ``NamedSharding``:

* :class:`Mesh` -- an object array of ``torch.device`` with named axes
  (``("data", "model")``, ``("pod", "data", "model")``).  A device may
  appear several times: four shards of one card, or of the CPU, partition
  and communicate exactly as four cards would.
* :class:`P` -- a partition spec, a tuple with one entry per tensor
  dimension: ``None`` (replicated), a mesh axis name, or a tuple of names.
  A one-name tuple is normalised to the name, as JAX does.
* :class:`NamedSharding` -- a mesh and a spec.

Model code annotates values with *logical* axes (``constrain(h, "batch",
None, "tp")``); :func:`activation_rules` activates the mesh-aware table
that resolves them, so the same code runs on one device (no rules: no-op),
a ``("data", "model")`` mesh or a ``("pod", "data", "model")`` one.  The
placement of sharded tensors and the collectives are in
:mod:`repro_torch.distributed.spmd`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from contextvars import ContextVar

import numpy as np
import torch

__all__ = [
    "DuplicateSpecError",
    "Mesh",
    "P",
    "NamedSharding",
    "activation_rules",
    "constrain",
    "logical_spec",
]


class DuplicateSpecError(ValueError):
    """A partition spec maps one mesh axis to two dimensions (JAX's
    ``DuplicateSpecError``)."""


class P(tuple):
    """A partition spec: one entry per dimension (``None``, an axis name or
    a tuple of axis names).  A one-name tuple is normalised to the name."""

    def __new__(cls, *axes):
        return super().__new__(
            cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes)
        )

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_names_of(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``()`` for a replicated dimension)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out on named axes (``jax.sharding.Mesh``).

    ``devices`` is an object array of ``torch.device`` whose dimensions are
    the axes, in order; ``shape[name]`` is an axis size and
    ``devices.size`` the shard count.  Flat (row-major) order numbers the
    shards: a sharded tensor keeps one tensor per shard in that order.
    """

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        devs = np.empty(np.shape(self.devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(self.devices, dtype=object)):
            devs[idx] = torch.device(d)
        names = tuple(self.axis_names)
        if devs.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not name the {devs.ndim} device dimensions")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> list[torch.device]:
        """The devices in shard order (one entry per shard)."""
        return list(self.devices.flat)

    def coord(self, i: int) -> dict[str, int]:
        """Shard ``i``'s index along every axis."""
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(i, self.devices.shape))))

    def index(self, coord: dict[str, int]) -> int:
        """The shard at ``coord`` (the inverse of :meth:`coord`)."""
        return int(np.ravel_multi_index([coord[a] for a in self.axis_names], self.devices.shape))

    def axis_size(self, entry) -> int:
        """The number of blocks a dimension with spec ``entry`` is cut into."""
        return math.prod(self.shape[a] for a in axis_names_of(entry))

    def block_index(self, i: int, entry) -> int:
        """Which of those blocks shard ``i`` holds (row-major over the entry's axes)."""
        c, idx = self.coord(i), 0
        for a in axis_names_of(entry):
            idx = idx * self.shape[a] + c[a]
        return idx

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.devices.shape, self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec (``jax.sharding.NamedSharding``).  A mesh
    axis splits one dimension at most: a spec that names it twice raises
    :class:`DuplicateSpecError`, as JAX's ``NamedSharding`` does."""

    mesh: Mesh
    spec: P

    def __post_init__(self):
        names = [n for e in self.spec for n in axis_names_of(e)]
        for n in names:
            if names.count(n) > 1:
                raise DuplicateSpecError(
                    f"{self.spec!r} maps the mesh axis {n!r} to more than one dimension"
                )


_RULES: ContextVar[dict | None] = ContextVar("sharding_rules", default=None)


def _build_table(mesh: Mesh) -> dict:
    names = mesh.axis_names
    batch = tuple(n for n in ("pod", "data") if n in names)
    return {
        "batch": batch or None,
        "seq": "data" if "data" in names else None,  # sequence parallelism
        "tp": "model" if "model" in names else None,
        "fsdp": "data" if "data" in names else None,
        None: None,
    }


@contextlib.contextmanager
def activation_rules(mesh: Mesh | None):
    token = _RULES.set(_build_table(mesh) if mesh is not None else None)
    try:
        yield
    finally:
        _RULES.reset(token)


def logical_spec(*logical) -> P | None:
    table = _RULES.get()
    if table is None:
        return None
    return P(*(table.get(a) for a in logical))


def constrain(x, *logical):
    """Reshard a sharded value to the logical axes if rules are active.

    JAX's ``with_sharding_constraint``: a :class:`~.spmd.Sharded` value is
    resharded (gathered or split) to the resolved spec; a plain tensor lives
    on one device and has nothing to constrain.  No-op without rules.
    """
    spec = logical_spec(*logical)
    if spec is None:
        return x
    from repro_torch.distributed.spmd import Sharded, reshard

    return reshard(x, spec) if isinstance(x, Sharded) else x
