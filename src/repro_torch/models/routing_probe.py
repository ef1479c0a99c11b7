"""The MoE routing of a run, recorded or replayed: support for checks.

A sharded run and a one-device run add their partial sums in other orders,
and a token whose k-th and (k+1)-th router probabilities lie within that
rounding may route to other experts: a discontinuity, not a fault.  The
checks that hold the mesh to one device (the tests, ``chip_smoke.py``,
``scripts/mesh_bf16_drift.py``) keep one run's routes and replay them in the
other, and count the tokens that routed apart beside their margins.

:func:`record_routing` does so by patching ``_top_k`` in ``models/mlp.py``
and ``models/sharded_moe.py`` (and ``sharded_moe._route``, to know the shard
each call is for) for as long as it runs; the model code holds no state of
it.  A patch is process-wide, so it also sees the chunks that autograd
recomputes on its own thread (remat).
"""

from __future__ import annotations

import contextlib
import math
from unittest import mock

import torch

from repro_torch.models import mlp, sharded_moe

__all__ = ["record_routing"]


@contextlib.contextmanager
def record_routing(keep: bool = False, replay: list | None = None):
    """Collect, over every MoE chunk run inside, the smallest top-k margin
    (the k-th minus the (k+1)-th router probability of a token) and the
    capacity drops (token-expert assignments past their expert's capacity,
    as ``mlp._dispatch`` drops them), of ``assigned`` in all.  A sharded
    run counts each batch block once.  Yields the dict it fills.

    ``keep``: also keep every chunk's routes, its top-k experts [B, C, k]
    and router probabilities in call order, under ``"routes"``.
    ``replay``: another run's kept routes, taken in the same order of calls
    (a sharded chunk takes its shards' batch rows of one): each chunk routes
    its tokens to those experts, gated at this run's probabilities.
    ``"next"`` counts the routes replayed, ``"moved"`` is the largest change
    of a router probability between the runs, ``"flips"`` counts the tokens
    whose own top k differ from the replayed, and ``"flip_ratio"`` is the
    largest, over them, of the replayed run's top-k margin over twice the
    largest change of any of the token's probabilities: above 1, that change
    cannot have swapped the token's experts."""
    rec = {
        "margin": math.inf, "drops": 0, "assigned": 0, "flips": 0, "flip_ratio": 0.0, "moved": 0.0,
        "routes": [] if keep else None, "next": 0,
    }
    top_k, route = mlp._top_k, sharded_moe._route
    chunk = {"run": None, "shard": 0, "replay": None}  # the sharded chunk being routed

    def next_route():
        if replay is None:
            return None
        rec["next"] += 1
        return replay[rec["next"] - 1]

    def one_device(cfg, logits):
        return _probe(rec, cfg, *top_k(cfg, logits), next_route(), keep)

    def sharded_route(run, cfg, router, xs):
        saved = dict(chunk)
        chunk.update(run=run, shard=0, replay=next_route())
        try:
            return route(run, cfg, router, xs)
        finally:
            chunk.update(saved)

    def sharded(cfg, logits):
        run, i, rows = chunk["run"], chunk["shard"], chunk["replay"]
        chunk["shard"] += 1
        if rows is not None:
            b0 = run.mesh.block_index(i, run.batch_spec) * logits.shape[0]
            rows = {k: v[b0 : b0 + logits.shape[0]] for k, v in rows.items()}
        # the replicas of a batch block route as it does: record each block once
        return _probe(rec if i in run.reps else None, cfg, *top_k(cfg, logits), rows, keep)

    with mock.patch.object(mlp, "_top_k", one_device), mock.patch.object(sharded_moe, "_top_k", sharded), \
            mock.patch.object(sharded_moe, "_route", sharded_route):
        yield rec


def _probe(rec: dict | None, cfg, probs: torch.Tensor, own: torch.Tensor, rows: dict | None, keep: bool):
    """Record one chunk's routing into ``rec`` (None: a replica, not
    recorded) and return (probs, the experts it routes to)."""
    idx = own if rows is None else rows["idx"]
    if rec is None:
        return probs, idx
    p = probs.detach()
    if cfg.top_k < cfg.n_experts:
        s = p.sort(dim=-1, descending=True).values
        rec["margin"] = min(rec["margin"], float((s[..., cfg.top_k - 1] - s[..., cfg.top_k]).min()))
    if rows is not None:
        q = rows["probs"]
        moved = (p - q).abs().amax(dim=-1)
        rec["moved"] = max(rec["moved"], float(moved.max()))
        flipped = (own.sort(dim=-1).values != idx.sort(dim=-1).values).any(dim=-1)
        n = int(flipped.sum())
        if n:
            qs = q.sort(dim=-1, descending=True).values
            margin = qs[..., cfg.top_k - 1] - qs[..., cfg.top_k]
            ratio = margin / (2 * moved).clamp_min(torch.finfo(torch.float32).tiny)
            rec["flips"] += n
            rec["flip_ratio"] = max(rec["flip_ratio"], float(ratio[flipped].max()))
    if keep:
        rec["routes"].append({"idx": idx, "probs": p})
    _, gates = mlp._gates(cfg, p, idx)
    disp, _ = mlp._dispatch(cfg, gates, torch.float32)
    assigned = int((gates > 0).sum())
    rec["assigned"] += assigned
    rec["drops"] += assigned - int(disp.sum())
    return probs, idx
