"""Compute/communication overlap: ring all-gather matmul.

Port of ``repro/distributed/overlap.py``.  A matmul against a weight
sharded on its contraction dim over the ``model`` axis decomposes into a
ring: at each of the g hops every rank multiplies the shard it holds
against the matching K-slice of x while the shard moves on to the next
rank, so the transfer hides behind the product except for the first hop:

    y = x @ W,  W sharded over the ring on its first dim
      = sum_s x[:, shard_s] @ W_s      (shards arrive around the ring)

One process drives every rank (``distributed/spmd.py``): a hop's transfer
is a copy of the resident shard onto the next rank's device, issued on a
side stream on a card (the product on the current stream waits for it only
at the next hop) and inline on the CPU.  The copy is made also where two
ranks share a device, so four ranks of one card move the bytes four
cards would.  Equal to the gathered matmul up to the order of the g
partial sums (each rank adds them starting from its own shard).
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import Mesh, NamedSharding, P
from repro_torch.distributed.spmd import shard

__all__ = ["ring_allgather_matmul", "ring_allgather_matmul_shardmap"]


def _send(w: torch.Tensor, dev: torch.device, streams: dict):
    """``(copy of w on dev, event or None)``: on a card the copy is issued on
    ``dev``'s side stream after the work that made ``w``; a reader waits on
    the event before using it."""
    if dev.type != "cuda":
        return w.to(dev, copy=True), None
    side = streams.setdefault(dev, torch.cuda.Stream(device=dev))
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(w.device))
    with torch.cuda.stream(side):
        side.wait_event(ready)
        out = w.to(dev, copy=True, non_blocking=True)
    w.record_stream(side)  # the source stays alive until the side copy has read it
    out.record_stream(torch.cuda.current_stream(dev))
    done = torch.cuda.Event()
    done.record(side)
    return out, done


def ring_allgather_matmul(xs: list, ws: list, devices: list) -> list:
    """One ring of g ranks: rank r holds x ``xs[r]`` [M, K] (replicated over
    the ring) and its shard ``ws[r]`` [K/g, N] of W, on ``devices[r]``.

    At hop s rank r holds the shard that started at rank (r - s) mod g,
    multiplies it against that K-slice of its x and passes it to rank
    r + 1.  Returns every rank's full [M, N] product.
    """
    g = len(ws)
    k_shard = ws[0].shape[0]
    accs = [torch.zeros((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device) for x, w in zip(xs, ws)]
    streams: dict = {}
    cur = [(w, None) for w in ws]
    for step in range(g):
        # start the next hop's transfers before this hop's products
        nxt = [_send(cur[(r - 1) % g][0], devices[r], streams) for r in range(g)] if step < g - 1 else None
        for r in range(g):
            w, arrived = cur[r]
            if arrived is not None:
                torch.cuda.current_stream(w.device).wait_event(arrived)
            src = (r - step) % g
            accs[r] = accs[r] + torch.matmul(xs[r][:, src * k_shard : (src + 1) * k_shard], w)
        cur = nxt
    return accs


def ring_allgather_matmul_shardmap(mesh: Mesh, axis_name: str = "model"):
    """``fn(x, w)``: the [M, K] x [K, N] matmul with W sharded P(axis, None)
    around a ring on each line of the mesh's ``axis_name`` and x replicated;
    returns the product whole on the mesh's first device."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis_name!r}")

    def fn(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xs = shard(x, NamedSharding(mesh, P())).shards
        ws = shard(w, NamedSharding(mesh, P(axis_name, None))).shards
        out = [None] * mesh.size
        rings: dict = {}
        for i in range(mesh.size):
            c = mesh.coord(i)
            rings.setdefault(tuple(v for a, v in c.items() if a != axis_name), []).append(i)
        for ranks in rings.values():
            res = ring_allgather_matmul(
                [xs[i] for i in ranks], [ws[i] for i in ranks], [mesh.flat[i] for i in ranks]
            )
            for i, y in zip(ranks, res):
                out[i] = y
        return out[0]

    return fn
