"""The MoE block over a named mesh: what XLA makes of ``moe_template``'s three layouts.

Each shard routes its batch block's tokens (replicated over ``model``) with
the whole router (FSDP-gathered) and JAX's top k, capacity and dispatch
(``models/mlp.py``: capacity is per batch row and chunk, so splitting the
batch drops exactly what one device drops).  The experts then run where
their layout puts them, read from the leaves' specs:

* ``"tp"``: experts over ``model``.  Each ``model`` shard runs its E / tp
  experts on its batch block's tokens and the combine's partials are
  all-reduced over ``model`` (no all-to-all: the tokens are replicated
  there).
* ``"megatron"``: experts replicated, each expert's F over ``model``:
  column-parallel gate and up, row-parallel down, one all-reduce over
  ``model`` after the combine.
* ``"fsdp"``: experts over ``data``, d_model over ``model``.  The capacity
  buffers ``expert_in`` [E, B, cap, D] go to the experts' owners by an
  all-to-all over ``data`` and ``expert_out`` comes back the same way;
  gate and up contract their D block and are all-reduced over ``model``,
  down's D blocks are all-gathered.

A dimension the mesh does not divide was left whole by ``partition_spec``,
and the same code runs it whole.  The load-balance aux is a product of
global means: the per-expert sums of probabilities and assignments are
all-reduced over the batch axes before the division by the global count,
so every shard holds the one-device aux.  Expert products stay einsums,
as JAX computes them outside any Pallas kernel; the shared experts are a
dense MLP (``qdot``, hence ``quant_matmul`` when quantized).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.spmd import all_reduce, all_to_all, local, local_tree
from repro_torch.models.mlp import _chunks, _dispatch, _experts, _gates, _shared_cfg, _top_k

__all__ = ["moe"]


def _axis(entry, run, name: str) -> bool:
    """Whether a spec entry splits its dimension over mesh axis ``name`` (size > 1)."""
    return entry == name and run.mesh.shape.get(name, 1) > 1


def _route(run, cfg, router: list, xs: list):
    """Every shard's gates [B, C, E] and its copy of the chunk's aux, from
    the per-expert sums all-reduced over the batch axes (``_top_k`` is
    called once a shard, in shard order)."""
    gates, me, ce = [], [], []
    for i, x in enumerate(xs):
        logits = torch.einsum("bcd,de->bce", x.to(torch.float32), router[i].to(torch.float32))
        probs, top_idx = _top_k(cfg, logits)
        onehot, g = _gates(cfg, probs, top_idx)
        gates.append(g)
        me.append(torch.sum(probs, dim=(0, 1)))
        ce.append(torch.sum(torch.sum(onehot, dim=2), dim=(0, 1)))
    me = all_reduce(me, run.mesh, run.batch_axes)
    ce = all_reduce(ce, run.mesh, run.batch_axes)
    B, C = xs[0].shape[:2]
    count = B * C * math.prod(run.mesh.shape[a] for a in run.batch_axes)
    aux = [cfg.n_experts * torch.sum((m / count) * (c / count)) for m, c in zip(me, ce)]
    return gates, aux


def _expert_ffn(run, p, xin: list) -> list:
    """The experts' SwiGLU on every shard's buffers [E_l, B, cap, D].  With
    d_model over ``model`` each shard contracts its D block for gate / up
    (partials all-reduced) and all-gathers down's D blocks; otherwise each
    runs its blocks (an F block's output is a partial, reduced after the
    combine)."""
    wg = p["w_gate"]
    if not _axis(wg.spec[1], run, "model"):
        return [_experts(local_tree(p, i), x) for i, x in enumerate(xin)]
    Dl = wg.shards[0].shape[1]
    dt = xin[0].dtype
    xl = [x.narrow(-1, run.m[i] * Dl, Dl) for i, x in enumerate(xin)]
    gate = run.psum([
        torch.einsum("ebkd,edf->ebkf", x, local(wg, i).to(dt)) for i, x in enumerate(xl)
    ])
    up = run.psum([
        torch.einsum("ebkd,edf->ebkf", x, local(p["w_up"], i).to(dt)) for i, x in enumerate(xl)
    ])
    out = [
        torch.einsum("ebkf,efd->ebkd", F.silu(g) * u, local(p["w_down"], i).to(dt))
        for i, (g, u) in enumerate(zip(gate, up))
    ]
    return run.gather(out)


def _moe_chunk(run, cfg, p, router: list, xs: list):
    """One chunk [B, C, D] on every shard -> (out per shard, aux per shard)."""
    gates, aux = _route(run, cfg, router, xs)
    dc = [_dispatch(cfg, g, x.dtype) for g, x in zip(gates, xs)]
    spec = p["w_gate"].spec
    e_model, e_data = _axis(spec[0], run, "model"), _axis(spec[0], run, "data")
    if e_model:  # each model shard's experts
        El = p["w_gate"].shards[0].shape[0]
        dc = [(d.narrow(2, run.m[i] * El, El), c.narrow(2, run.m[i] * El, El)) for i, (d, c) in enumerate(dc)]
    xin = [torch.einsum("bcek,bcd->ebkd", d, x) for (d, _), x in zip(dc, xs)]  # [E(_l),B,cap,D]
    if e_data:  # the buffers to the experts' owners: [E/dp, B * dp, cap, D]
        xin = all_to_all(xin, run.mesh, "data", 0, 1)
    out = _expert_ffn(run, p, xin)
    if e_data:  # and back: [E, B, cap, D]
        out = all_to_all(out, run.mesh, "data", 1, 0)
    out = [torch.einsum("bcek,ebkd->bcd", c, o) for (_, c), o in zip(dc, out)]
    if e_model or _axis(spec[2], run, "model"):
        out = run.psum(out)
    return out, aux


def moe(run, p, hs: list):
    """``mlp.moe_apply`` on every shard: hs [B_l, S, D] -> (out per shard,
    aux per shard, each the one-device aux of the global batch)."""
    cfg = run.cfg.moe
    S = hs[0].shape[1]
    router = [local(p["router"], i) for i in range(run.n)]
    chunks = [_chunks(cfg, h) for h in hs]
    n_chunks = len(chunks[0])
    aux = [torch.zeros((), dtype=torch.float32, device=h.device) for h in hs]
    outs = [[] for _ in hs]
    for c in range(n_chunks):
        out, a = _moe_chunk(run, cfg, p, router, [ch[c] for ch in chunks])
        aux = [u + v for u, v in zip(aux, a)]
        for o, t in zip(outs, out):
            o.append(t)
    out = [torch.cat(o, dim=1)[:, :S] for o in outs]
    if cfg.n_shared:
        shared = run.mlp(p["shared"], hs, _shared_cfg(cfg))
        out = [o + s for o, s in zip(out, shared)]
    return out, [cfg.router_aux_weight * a / max(1, n_chunks) for a in aux]
