"""Device meshes for the launchers (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device.  A mesh is ``core/shard.py``'s 1-D :class:`DeviceMesh`; JAX's named
2-D / 3-D axes (``data``, ``model``, ``pod``) carry XLA sharding, which has
no port yet (ROADMAP Queue 1 #5 and #6).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.shard import DeviceMesh, make_mesh

__all__ = ["make_production_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The target deployment mesh of JAX's dry-run: 16x16 = 256 devices, or
    2x16x16 = 512.  Refuses, as JAX does, when fewer devices are visible."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = math.prod(shape)
    visible = torch.cuda.device_count()
    if visible < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices but only {visible} are visible"
        )
    return make_mesh(n)


def make_host_mesh() -> DeviceMesh:
    """Every card of this host (the CPU on a host without one)."""
    return make_mesh()
