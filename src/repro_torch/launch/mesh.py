"""Device meshes for the launchers (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device.  A mesh is :class:`~repro_torch.distributed.sharding.Mesh`, named
as JAX's: ``data`` carries DP + FSDP, ``model`` TP, ``pod`` (when present)
pure DP.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh

__all__ = ["make_production_mesh", "make_host_mesh", "make_mesh"]


def make_mesh(shape, devices, axes=("data", "model")) -> Mesh:
    """A mesh of ``shape`` over ``devices`` in row-major order.  The list may
    name a device several times (four shards of one card, or of the CPU);
    its length must be the product of the axis sizes."""
    shape = tuple(int(n) for n in shape)
    devices = [torch.device(d) for d in devices]
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {tuple(axes)}")
    if math.prod(shape) != len(devices):
        raise ValueError(
            f"mesh {shape} needs {math.prod(shape)} devices, {len(devices)} were given"
        )
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The target deployment mesh of JAX's dry run: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model").  On ``cuda`` it
    refuses, as JAX does, when fewer cards are visible.  ``device="meta"``
    builds it from the meta device repeated 256 or 512 times, the dry run's
    mesh (``launch/dryrun.py``; JAX forces as many host devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if torch.device(device).type == "meta":
        return make_mesh(shape, ["meta"] * n, axes)
    visible = torch.cuda.device_count()
    if visible < n:
        raise RuntimeError(f"mesh {shape} needs {n} devices but only {visible} are visible")
    return make_mesh(shape, [torch.device("cuda", i) for i in range(n)], axes)


def make_host_mesh(device="cuda") -> Mesh:
    """Whatever this host has: every card as (n, 1) over ("data", "model"),
    or one CPU device where ``device`` is the CPU."""
    if torch.device(device).type == "cpu":
        return make_mesh((1, 1), ["cpu"])
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_host_mesh: no CUDA device; pass device='cpu' for the CPU")
    return make_mesh((n, 1), [torch.device("cuda", i) for i in range(n)])
