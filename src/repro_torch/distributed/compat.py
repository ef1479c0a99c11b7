"""Multi-process runtime queries over ``torch.distributed`` (port of
``repro/distributed/compat.py``).

The Flex-plorer's fleet fan-out partitions a sweep's candidates by process
and all-gathers the scores (``core/shard.py::host_bounds`` /
``allgather_hosts``); this module answers how many processes there are and
which one this is, and starts the process group when a coordinator is
configured.  The values crossing processes are small numpy arrays on the
host, so the group is gloo.

JAX's ``shard_map`` and ``pcast_varying`` have no counterpart here:
``core/shard.py`` splits the work across devices itself.
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch.distributed as dist

__all__ = [
    "enable_compilation_cache",
    "process_count",
    "process_index",
    "maybe_init_distributed",
]

#: How long ``init_process_group`` waits for every process to join.
INIT_TIMEOUT = datetime.timedelta(seconds=120)


def enable_compilation_cache(cache_dir) -> bool:
    """Always False, JAX's "not enabled" answer: the port compiles nothing
    per shape (its kernels are built once into ``build/kernels/``)."""
    return False


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Number of cooperating processes: the process group's world size, 1
    when no group is initialised."""
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's rank in [0, process_count())."""
    return dist.get_rank() if _initialized() else 0


def _init_method(address: str) -> str:
    """``host:port`` as a ``tcp://`` URL; a URL (``tcp://``, ``file://``) as given."""
    return address if "://" in address else f"tcp://{address}"


def maybe_init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Start a gloo process group when a coordinator is configured.

    Resolution order, as in JAX: the explicit arguments, then torchrun's
    environment -- ``MASTER_ADDR`` and ``MASTER_PORT`` (the coordinator,
    ``host:port``), ``WORLD_SIZE`` and ``RANK``.  ``coordinator_address``
    is ``host:port`` or an ``init_method`` URL (``tcp://...``,
    ``file://...``).  With no coordinator this is a no-op that returns
    False: the caller runs in one process.  A failed initialisation warns
    and returns False, and the run carries on in one process.  Returns True
    when a process group is up (an already-initialised group short-circuits).
    """
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if addr is None:
        return False
    if _initialized():
        return True
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    try:
        dist.init_process_group(
            "gloo",
            init_method=_init_method(addr),
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
            timeout=INIT_TIMEOUT,
        )
        return True
    except (RuntimeError, ValueError) as e:
        warnings.warn(
            f"torch.distributed.init_process_group({addr!r}) failed ({e}); continuing "
            "in one process",
            RuntimeWarning,
            stacklevel=2,
        )
        return False
