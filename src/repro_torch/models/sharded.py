"""Sharded execution of the dense decoder LM over a named mesh.

What XLA's SPMD partitioner makes of JAX's specs for ``models/transformer.py``'s
dense blocks (``partition_specs`` of the template, ``input_pspecs``,
``cache_pspecs``), run shard by shard from one process through
:mod:`repro_torch.distributed.spmd`:

* every parameter leaf is all-gathered over the axes other than ``model``
  before use (FSDP), a repeat group at a time inside the group's body, so
  ``remat="block"`` gathers again in the backward pass; autograd
  reduce-scatters the gradients back onto the shards;
* column-parallel ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up`` (and the
  biases), local heads, row-parallel ``wo`` / ``w_down`` followed by an
  all-reduce over ``model``.  Where the kv heads do not divide over
  ``model`` (JAX's cache specs replicate there), Q / K / V are all-gathered
  and every model shard attends all heads;
* a vocab-parallel ``embed`` (a masked lookup and an all-reduce, exact) and
  head: the chunked CE combines the max and the log-sum-exp across the
  ``model`` shards in f32, in ``_chunked_ce``'s 512-token chunks;
* the batch over ``data`` (and ``pod``) by ``input_pspecs``; the loss adds
  each batch shard's token losses once and divides by the global count.

A dimension that does not divide over its axis was left replicated by
``partition_spec``; the same code then runs it whole on every shard.  Only
the dense family is ported; the others raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.precision import QTensor, qdot, tree_map
from repro_torch.distributed.sharding import NamedSharding, P, axis_names_of
from repro_torch.distributed.spmd import (
    Sharded,
    all_gather,
    all_reduce,
    local,
    local_tree,
    reshard,
    shard,
)
from repro_torch.models.common import rms_norm, unstack
from repro_torch.models.mlp import MLPConfig, mlp_hidden
from repro_torch.models.transformer import (
    ModelConfig,
    _attend,
    _ce_chunk,
    _head_logits,
    _qkv,
    layer_pattern,
    n_groups,
)

__all__ = ["check_dense", "lm_loss", "prefill", "decode_step"]

UNPORTED = (
    "{what} over a mesh of {n} shards is not ported for {name} (family {family}): "
    "only the dense family shards yet (ROADMAP Queue 1 #5c)"
)


def check_dense(cfg, what: str, n_shards: int) -> None:
    """Refuse a config whose blocks have no sharded execution yet."""
    dense = isinstance(cfg, ModelConfig) and cfg.family == "dense" and cfg.moe is None
    if not (dense and cfg.ssm is None and cfg.attn_period == 0 and not cfg.mrope):
        raise NotImplementedError(
            UNPORTED.format(what=what, n=n_shards, name=cfg.name, family=getattr(cfg, "family", "?"))
        )


def _spec(leaf) -> P:
    return leaf.q.spec if isinstance(leaf, QTensor) else leaf.spec


def _model_dim(leaf) -> int | None:
    """Which dimension of a leaf is split over ``model`` (None: replicated)."""
    spec = _spec(leaf)
    return spec.index("model") if "model" in spec else None


def _tp_layout(leaf):
    """The leaf gathered over every axis but ``model`` (FSDP's gather before use)."""
    if isinstance(leaf, QTensor):
        return QTensor(_tp_layout(leaf.q), _tp_layout(leaf.scale), leaf.bits, leaf.shape)
    return reshard(leaf, P(*(a if a == "model" else None for a in leaf.spec)))


def _layers(tree, n: int) -> list:
    """Each repeat group's slice of every stacked leaf (each leaf unbound once)."""

    def split(_, w):
        if isinstance(w, QTensor):
            return [QTensor(q, s, w.bits, w.shape[1:]) for q, s in zip(w.q.unbind0(), w.scale.unbind0())]
        return w.unbind0()

    parts = tree_map(split, tree)
    return [tree_map(lambda _, s: s[g], parts) for g in range(n)]


def _partial(x: torch.Tensor, w) -> torch.Tensor:
    """A row block's partial product.  A quantized block's comes out of the
    ``quant_matmul`` kernel in f32, so the all-reduce adds f32 partials and
    rounds once, as the one-device launch does; a float block's is rounded
    to x's dtype by the matmul, and the all-reduce adds those in f32 and
    rounds again (one extra rounding under bf16)."""
    if not isinstance(w, QTensor):
        return qdot(x, w)
    # imported here, as qdot does, so that the launch goes through the module's name
    from repro_torch.kernels.quant_matmul import quant_matmul as qm

    K, N = w.shape
    out = qm.quant_matmul(
        x.reshape(-1, K).contiguous(), w.q, w.scale, bits=w.bits, out_dtype=torch.float32
    )
    return out.reshape(*x.shape[:-1], N)


class _Run:
    """One sharded pass: the config, the mesh and its ``model`` axis."""

    def __init__(self, cfg: ModelConfig, params):
        self.cfg = cfg
        self.mesh = _mesh_of(params)
        check_dense(cfg, "the LM", self.mesh.size)
        self.n = self.mesh.size
        self.tp = self.mesh.shape.get("model", 1)
        self.m = [self.mesh.coord(i).get("model", 0) for i in range(self.n)]
        has_model = "model" in self.mesh.axis_names
        self.kv_axis = "model" if has_model and cfg.n_kv_heads % self.tp == 0 else None
        self.heads_local = self.tp > 1 and self.kv_axis is not None
        if self.heads_local:
            attn = params["blocks"]["pos0"]["attn"]
            if any(_model_dim(attn[w]) != 2 for w in ("wq", "wk", "wv")):
                raise ValueError("the kv heads divide over 'model' but wq / wk / wv are not split")
            self.lcfg = dataclasses.replace(
                cfg, n_heads=cfg.n_heads // self.tp, n_kv_heads=cfg.n_kv_heads // self.tp
            )
        else:
            self.lcfg = cfg

    def psum(self, xs: list) -> list:
        return all_reduce(xs, self.mesh, ("model",))

    def gather(self, xs: list) -> list:
        return all_gather(xs, self.mesh, "model", -1)

    def row(self, xs: list, split: bool, w) -> list:
        """``x @ w`` where ``xs`` are split over ``model`` on their last dim
        (``split``) or whole: a row-split ``w`` takes the matching blocks
        and its partial products are all-reduced."""
        if _model_dim(w) == 0:
            if not split:
                k = local(w, 0).shape[0]
                xs = [x.narrow(-1, self.m[i] * k, k) for i, x in enumerate(xs)]
            parts = self.psum([_partial(x, local(w, i)) for i, x in enumerate(xs)])
            return [t.to(x.dtype) for t, x in zip(parts, xs)]
        if split:
            xs = self.gather(xs)
        return [qdot(x, local(w, i)) for i, x in enumerate(xs)]

    # -- blocks ----------------------------------------------------------
    def block(self, kind, p, xs, positions, mode, caches):
        """One pre-norm dense block on every shard; ``p`` is the layer's
        leaves in the TP layout.  Returns (xs, per-shard new caches)."""
        cfg, lp = self.cfg, [local_tree(p, i) for i in range(self.n)]
        hs = [rms_norm(x, lp[i]["norm1"]) for i, x in enumerate(xs)]
        qkv = [_qkv(cfg, lp[i]["attn"], h) for i, h in enumerate(hs)]
        if not self.heads_local:  # all heads on every shard
            cols = [
                self.gather(list(c)) if _model_dim(p["attn"][w]) == 1 else list(c)
                for c, w in zip(zip(*qkv), ("wq", "wk", "wv"))
            ]
            qkv = list(zip(*cols))
        outs, new = zip(*(
            _attend(self.lcfg, kind, *qkv[i], positions[i], None, mode,
                    None if caches is None else caches[i])
            for i in range(self.n)
        ))
        mix = self.row(list(outs), self.heads_local, p["attn"]["wo"])
        if cfg.sandwich_norm:
            mix = [rms_norm(t, lp[i]["post_norm1"]) for i, t in enumerate(mix)]
        xs = [x + t for x, t in zip(xs, mix)]
        if cfg.d_ff > 0:
            mcfg = MLPConfig(cfg.d_model, cfg.d_ff, cfg.act)
            hid = [mlp_hidden(mcfg, lp[i]["mlp"], rms_norm(x, lp[i]["norm2"])) for i, x in enumerate(xs)]
            ff = self.row(hid, _model_dim(p["mlp"]["w_up"]) == 1, p["mlp"]["w_down"])
            if cfg.sandwich_norm:
                ff = [rms_norm(t, lp[i]["post_norm2"]) for i, t in enumerate(ff)]
            xs = [x + t for x, t in zip(xs, ff)]
        return xs, list(new)

    def scan(self, params, xs, positions, mode, caches):
        """The repeat groups in order; the group's leaves are gathered inside
        its body.  ``caches``: per shard, the local stacked decode caches
        (written in place).  Returns (xs, {pos: per group, per shard new cache})."""
        cfg, pattern, ng = self.cfg, layer_pattern(self.cfg), n_groups(self.cfg)
        groups = _layers(params["blocks"], ng)
        per_shard = None if caches is None else [unstack(c, ng) for c in caches]
        new = {f"pos{i}": [] for i in range(len(pattern))}
        for g in range(ng):

            def body(*xs, bp=groups[g], g=g):
                bp = tree_map(lambda _, w: _tp_layout(w), bp)
                xs = list(xs)
                for i, kind in enumerate(pattern):
                    ci = None if per_shard is None else [c[g][f"pos{i}"] for c in per_shard]
                    xs, nc = self.block(kind, bp[f"pos{i}"], xs, positions, mode, ci)
                    new[f"pos{i}"].append(nc)
                return tuple(xs)

            if mode == "train" and cfg.remat == "block" and torch.is_grad_enabled():
                xs = list(checkpoint(body, *xs, use_reentrant=False))
            else:
                xs = list(body(*xs))
        return xs, new

    # -- embedding and head ----------------------------------------------
    def embed(self, E: Sharded, tokens: list) -> list:
        """Vocab-parallel lookup: each shard takes the rows it holds, zeros
        elsewhere, and the all-reduce adds exact zeros -- the one-device bits."""
        if _model_dim(E) == 0:
            vl, rows = E.shards[0].shape[0], []
            for i, t in enumerate(tokens):
                t = t.to(torch.int64) - self.m[i] * vl
                r = E.shards[i][t.clamp(0, vl - 1)]
                zero = torch.zeros((), dtype=r.dtype, device=r.device)
                rows.append(torch.where(((t >= 0) & (t < vl))[..., None], r, zero))
            rows = self.psum(rows)
        else:
            rows = [E.shards[i][t] for i, t in enumerate(tokens)]
        h = [r.to(self.cfg.compute_dtype) for r in rows]
        if self.cfg.embed_scale:
            dt = self.cfg.compute_dtype
            h = [x * torch.tensor(self.cfg.d_model**0.5, dtype=dt, device=x.device) for x in h]
        return h

    def heads(self, top) -> tuple[list, bool]:
        """Each shard's head block [D, V_local] and whether it is vocab-split."""
        if self.cfg.tie_embeddings:
            E = top["embed"]
            return [t.T for t in E.shards], _model_dim(E) == 0
        H = top["lm_head"]
        return list(H.shards), _model_dim(H) == 1

    def logits(self, top, xs, batch_spec) -> torch.Tensor:
        """The last position's f32 logits [B, 1, V], whole on the first device."""
        heads, split = self.heads(top)
        fn = top["final_norm"]
        out = [
            _head_logits(self.cfg, rms_norm(x, fn.shards[i]), heads[i]) for i, x in enumerate(xs)
        ]
        return Sharded.from_local(out, self.mesh, P(batch_spec, None, "model" if split else None)).full()

    def ce_totals(self, top, hs: list, targets: list) -> list:
        """Each shard's summed token log-likelihoods, negated (``_chunked_ce``'s
        total before the division), over 512-token chunks."""
        heads, split = self.heads(top)
        S = hs[0].shape[1]
        chunk = _ce_chunk(S, 512)
        totals = [torch.zeros((), dtype=torch.float32, device=h.device) for h in hs]
        for c in range(0, S, chunk):
            lg = [_head_logits(self.cfg, h[:, c : c + chunk], hd) for h, hd in zip(hs, heads)]
            tc = [t[:, c : c + chunk].to(torch.int64) for t in targets]
            if not split:
                ll = [
                    torch.gather(torch.log_softmax(l, dim=-1), -1, t[..., None])[..., 0]
                    for l, t in zip(lg, tc)
                ]
            else:
                vl = lg[0].shape[-1]
                mx = all_reduce([l.detach().amax(-1) for l in lg], self.mesh, ("model",), op="max")
                se = self.psum([torch.exp(l - m[..., None]).sum(-1) for l, m in zip(lg, mx)])
                tl = []
                for i, (l, t) in enumerate(zip(lg, tc)):
                    t = t - self.m[i] * vl
                    g = torch.gather(l, -1, t.clamp(0, vl - 1)[..., None])[..., 0]
                    tl.append(torch.where((t >= 0) & (t < vl), g, torch.zeros((), device=g.device)))
                tl = self.psum(tl)
                ll = [t - (m + torch.log(s)) for t, m, s in zip(tl, mx, se)]
            totals = [tot - torch.sum(l) for tot, l in zip(totals, ll)]
        return totals

    def top(self, params) -> dict:
        return {k: _tp_layout(params[k]) for k in ("embed", "lm_head", "final_norm") if k in params}


def _mesh_of(params):
    e = params["embed"]
    return (e.q if isinstance(e, QTensor) else e).mesh


def _batch_leaf(mesh, x) -> Sharded:
    """A batch input as placed by ``input_pspecs`` (a global tensor is placed here)."""
    if isinstance(x, Sharded):
        return x
    from repro_torch.models.registry import _batch_axes

    spec = P(_batch_axes(mesh, x.shape[0]), *(None,) * (x.dim() - 1))
    return shard(x, NamedSharding(mesh, spec))


def _representatives(mesh, batch_spec) -> list[int]:
    """One shard per distinct batch block: the one at 0 on every other axis."""
    keep = set(axis_names_of(batch_spec))
    return [
        i for i in range(mesh.size)
        if all(v == 0 for a, v in mesh.coord(i).items() if a not in keep)
    ]


def lm_loss(cfg: ModelConfig, params, batch: dict):
    """``transformer.lm_loss`` over the mesh of ``params``' sharded leaves."""
    run = _Run(cfg, params)
    mesh = run.mesh
    tokens, targets = _batch_leaf(mesh, batch["tokens"]), _batch_leaf(mesh, batch["targets"])
    top = run.top(params)
    xs = run.embed(top["embed"], tokens.shards)
    positions = [torch.arange(x.shape[1], device=x.device) for x in xs]
    xs, _ = run.scan(params, xs, positions, "train", None)
    hs = [rms_norm(x, top["final_norm"].shards[i]) for i, x in enumerate(xs)]
    totals = run.ce_totals(top, hs, targets.shards)
    dev = mesh.flat[0]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for i in _representatives(mesh, targets.spec[0]):
        total = total + totals[i].to(dev)
    B, S = targets.shape
    ce = total / (B * S)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(cfg: ModelConfig, params, tokens):
    """``transformer.prefill`` over the mesh: (logits [B, 1, V] whole on the
    mesh's first device, caches sharded by ``cache_pspecs``)."""
    run = _Run(cfg, params)
    mesh = run.mesh
    tokens = _batch_leaf(mesh, tokens)
    top = run.top(params)
    xs = run.embed(top["embed"], tokens.shards)
    positions = [torch.arange(x.shape[1], device=x.device) for x in xs]
    xs, new = run.scan(params, xs, positions, "prefill", None)
    b = tokens.spec[0]
    kv = P(None, b, None, run.kv_axis, None)
    specs = {"k": kv, "v": kv, "len": P(None, b)}
    caches = {
        pos: {
            name: Sharded.from_local(
                [torch.stack([grp[i][name] for grp in per_group]) for i in range(run.n)], mesh, spec
            )
            for name, spec in specs.items()
        }
        for pos, per_group in new.items()
    }
    return run.logits(top, [x[:, -1:] for x in xs], b), caches


def decode_step(cfg: ModelConfig, params, caches, tokens, cur_len):
    """``transformer.decode_step`` over the mesh: each shard appends to its
    blocks of the sharded ``caches`` in place; returns (logits whole on the
    mesh's first device, caches)."""
    run = _Run(cfg, params)
    mesh = run.mesh
    tokens, cur_len = _batch_leaf(mesh, tokens), _batch_leaf(mesh, cur_len)
    top = run.top(params)
    xs = run.embed(top["embed"], tokens.shards)
    positions = [c[:, None] for c in cur_len.shards]
    local_caches = [local_tree(caches, i) for i in range(run.n)]
    xs, _ = run.scan(params, xs, positions, "decode", local_caches)
    return run.logits(top, xs, tokens.spec[0]), caches
