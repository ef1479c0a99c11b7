"""Sharded execution of the decoder LM over a named mesh.

What XLA's SPMD partitioner makes of JAX's specs for ``models/transformer.py``
(``partition_specs`` of the template, ``input_pspecs``, ``cache_pspecs``),
run shard by shard from one process through
:mod:`repro_torch.distributed.spmd`:

* every parameter leaf is all-gathered over the axes other than ``model``
  before use (FSDP), a repeat group at a time inside the group's body, so
  ``remat="block"`` gathers again in the backward pass; autograd
  reduce-scatters the gradients back onto the shards.  The experts of the
  ``"fsdp"`` MoE layout stay split over ``data`` (``models/sharded_moe.py``);
* column-parallel ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up`` (and the
  biases), local heads, row-parallel ``wo`` / ``w_down`` followed by an
  all-reduce over ``model``.  Where the kv heads do not divide over
  ``model`` (JAX's cache specs replicate there), Q / K / V are all-gathered
  and every model shard attends all heads;
* MoE blocks by their expert layout (``models/sharded_moe.py``) and SSM
  mixers with their heads over ``model`` (``models/sharded_ssm.py``);
* a vocab-parallel ``embed`` (a masked lookup and an all-reduce, exact) and
  head: the chunked CE combines the max and the log-sum-exp across the
  ``model`` shards in f32, in ``_chunked_ce``'s 512-token chunks;
* every batch input by ``input_pspecs`` (the batch over ``data`` and
  ``pod``; ``positions3`` on its dim 1); the VLM's patch embeddings are
  prepended per batch shard and the loss runs over the text tail; the loss
  adds each batch block's token losses once and divides by the global
  count, and takes the MoE aux (global means) once.

A dimension that does not divide over its axis was left replicated by
``partition_spec``; the same code then runs it whole on every shard.

Decode caches whose sequence is split over ``data`` (``cache_pspecs(...,
shard_seq=True)``, the long_500k layout) take the decode path XLA makes of
``decode_attend`` under that spec: only the shard whose block holds a
row's ``len`` writes the new K / V there, every shard's ``len`` advances,
and the softmax runs in two passes over ``data`` -- an all-reduce of the
blocks' maxima, then of their f32 sums of ``exp(s - max)`` and of
``exp(s - max) @ v`` -- and divides.  A block with no valid position adds
exact zeros.  Whisper runs through the same pieces
(``models/sharded_whisper.py``).
"""

from __future__ import annotations

import dataclasses
import re

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
from repro_torch.models.attention import NEG_INF, _gqa_scores, _softcap
from repro_torch.models.common import rms_norm, unstack
from repro_torch.models.mlp import MLPConfig, mlp_hidden
from repro_torch.models.transformer import (
    ModelConfig,
    _attend,
    _cache_entry,
    _ce_chunk,
    _default_pos3,
    _head_logits,
    _qkv,
    _rotary_heads,
    cache_specs,
    layer_pattern,
    n_groups,
)

__all__ = ["lm_loss", "prefill", "decode_step"]


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


# the routed experts' leaves, whose ``"fsdp"`` layout keeps the experts over data
_EXPERTS = re.compile(r"pos\d+/moe/(w_gate|w_up|w_down)")


def _group_layout(path: str, leaf):
    """A repeat group's leaf as its blocks use it: FSDP-gathered, except
    that experts split over ``data`` stay there (the tokens travel)."""
    if _EXPERTS.fullmatch(path) and not isinstance(leaf, QTensor) and leaf.spec[0] is not None:
        keep = leaf.spec[0]
        return reshard(leaf, P(keep, *(a if a == "model" else None for a in leaf.spec[1:])))
    return _tp_layout(leaf)


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
    """One sharded pass: the config, the mesh, its ``model`` axis and the
    batch's layout."""

    def __init__(self, cfg: ModelConfig, params, batch_spec):
        self.on_mesh(cfg, params, batch_spec, cfg.n_kv_heads)
        pattern = layer_pattern(cfg)
        attn = [params["blocks"][f"pos{i}"]["attn"] for i, k in enumerate(pattern) if k.mixer == "attn"]
        self.heads_local = self.tp > 1 and self.kv_axis is not None and bool(attn)
        if self.heads_local:
            if any(_model_dim(attn[0][w]) != 2 for w in ("wq", "wk", "wv")):
                raise ValueError("the kv heads divide over 'model' but wq / wk / wv are not split")
            self.lcfg = dataclasses.replace(
                cfg, n_heads=cfg.n_heads // self.tp, n_kv_heads=cfg.n_kv_heads // self.tp
            )
        else:
            self.lcfg = cfg

    def on_mesh(self, cfg, params, batch_spec, n_kv: int) -> None:
        """The mesh's fields: shards, ``model`` coordinates, the batch's
        layout and the kv heads' axis (``n_kv`` heads)."""
        self.cfg = cfg
        self.mesh = _mesh_of(params)
        self.n = self.mesh.size
        self.tp = self.mesh.shape.get("model", 1)
        self.m = [self.mesh.coord(i).get("model", 0) for i in range(self.n)]
        self.batch_spec = batch_spec
        self.batch_axes = axis_names_of(batch_spec)
        # one shard per batch block: what counts each token once
        self.reps = _representatives(self.mesh, batch_spec)
        has_model = "model" in self.mesh.axis_names
        # the kv heads' (and the SSM caches') axis, as cache_pspecs places them
        self.kv_axis = "model" if has_model and n_kv % self.tp == 0 else None
        # the decode caches' sequence axis (``decode_step`` reads it off the caches)
        self.seq_axis = None

    def psum(self, xs: list) -> list:
        return all_reduce(xs, self.mesh, ("model",))

    def gather(self, xs: list) -> list:
        return all_gather(xs, self.mesh, "model", -1)

    def whole(self, leaf) -> list:
        """Every shard's copy of a leaf whole (gathered over ``model`` if split)."""
        if self.tp > 1 and _model_dim(leaf) is not None:
            leaf = reshard(leaf, P(*(None,) * leaf.ndim))
        return [local(leaf, i) for i in range(self.n)]

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

    def mlp(self, p, hs: list, mcfg: MLPConfig) -> list:
        """A dense MLP: column-parallel hidden layer, row-parallel ``w_down``."""
        hid = [mlp_hidden(mcfg, local_tree(p, i), h) for i, h in enumerate(hs)]
        return self.row(hid, _model_dim(p["w_up"]) == 1, p["w_down"])

    # -- blocks ----------------------------------------------------------
    def attn(self, kind, p, hs, positions, pos3, mode, caches):
        """Attention over local (or gathered) heads: (out, per-shard new caches)."""
        cfg = self.cfg
        qkv = [_qkv(cfg, local_tree(p, i), h) for i, h in enumerate(hs)]
        if not self.heads_local:  # all heads on every shard
            cols = [
                self.gather(list(c)) if _model_dim(p[w]) == 1 else list(c)
                for c, w in zip(zip(*qkv), ("wq", "wk", "wv"))
            ]
            qkv = list(zip(*cols))
        if mode == "decode" and self.seq_axis is not None:
            outs, new = self.seq_decode(kind, qkv, positions, pos3, caches), caches
        else:
            outs, new = zip(*(
                _attend(self.lcfg, kind, *qkv[i], positions[i], None if pos3 is None else pos3[i],
                        mode, None if caches is None else caches[i])
                for i in range(self.n)
            ))
        return self.row(list(outs), self.heads_local, p["wo"]), list(new)

    def seq_decode(self, kind, qkv, positions, pos3, caches) -> list:
        """``_attend``'s decode against caches split over ``seq_axis`` on
        their sequence: rotary, the append, then :meth:`seq_attend`."""
        cfg, qs = self.lcfg, []
        for i, (q, k, v) in enumerate(qkv):
            q, k, v = _rotary_heads(cfg, q, k, v, positions[i], None if pos3 is None else pos3[i], "decode")
            k, v, inv = _cache_entry(cfg, k, v, caches[i]["k"].dtype)
            self.seq_append(i, caches[i], k, v)
            qs.append(q)
        outs = self.seq_attend(qs, caches, softcap=cfg.attn_softcap, window=kind.window, kv_inv_scale=inv)
        return [o.reshape(o.shape[0], 1, -1) for o in outs]

    def seq_append(self, i: int, cache: dict, k_new, v_new) -> None:
        """``KVCache.append_one`` on shard ``i``'s block of a sequence-split
        cache, in place: each row's K / V lands where its (clamped) ``len``
        falls, on the shard whose block holds it (the others write back
        what they hold), and this shard's ``len`` advances."""
        S_l = cache["k"].shape[1]
        S = S_l * self.mesh.axis_size(self.seq_axis)
        at = cache["len"].clamp(max=S - 1).long() - self.mesh.block_index(i, self.seq_axis) * S_l
        mine = (at >= 0) & (at < S_l)
        rows, at = torch.arange(at.shape[0], device=at.device), at.clamp(0, S_l - 1)
        for name, new in (("k", k_new), ("v", v_new)):
            t = cache[name]
            t[rows, at] = torch.where(mine[:, None, None], new[:, 0], t[rows, at])
        cache["len"] += 1

    def seq_attend(self, qs: list, caches: list, *, softcap=None, window=None, kv_inv_scale=None) -> list:
        """``decode_attend`` over caches split over ``seq_axis`` on their
        sequence, in two passes over that axis: the global max of the masked
        scores, then the f32 sums of ``exp(s - max)`` and of ``exp(s - max)
        @ v``, each all-reduced; their quotient is the softmax's output.
        q [B, 1, Hq, D] per shard -> [B, 1, Hq, D] per shard."""
        axes, scores = (self.seq_axis,), []
        for i, (q, c) in enumerate(zip(qs, caches)):
            S_l = c["k"].shape[1]
            k_pos = self.mesh.block_index(i, self.seq_axis) * S_l + torch.arange(S_l, device=q.device)
            valid = k_pos[None] < c["len"][:, None]
            if window is not None:
                valid &= k_pos[None] >= (c["len"][:, None] - window)
            s = _gqa_scores(q, c["k"], q.shape[-1] ** -0.5)  # [B,Hk,G,1,S_l]
            if kv_inv_scale is not None:
                s = s * kv_inv_scale
            s = _softcap(s, softcap)
            scores.append(torch.where(valid[:, None, None, None], s, NEG_INF))
        mx = all_reduce([s.amax(-1, keepdim=True) for s in scores], self.mesh, axes, op="max")
        ex = [torch.exp(s - m) for s, m in zip(scores, mx)]  # a block with nothing valid: zeros
        den = all_reduce([e.sum(-1) for e in ex], self.mesh, axes)  # [B,Hk,G,1]
        num = all_reduce(
            [torch.einsum("bhgqk,bkhd->bqhgd", e, c["v"].to(torch.float32)) for e, c in zip(ex, caches)],
            self.mesh, axes,
        )
        outs = []
        for q, n, d in zip(qs, num, den):
            out = n / d.permute(0, 3, 1, 2)[..., None]
            if kv_inv_scale is not None:
                out = out * kv_inv_scale
            outs.append(out.reshape(q.shape).to(q.dtype))
        return outs

    def block(self, kind, p, xs, positions, pos3, mode, caches):
        """One pre-norm block on every shard; ``p`` is the layer's leaves in
        the group's layout.  Returns (xs, per-shard new caches, per-shard
        aux or None)."""
        # imported here: both modules import this one
        from repro_torch.models.sharded_moe import moe
        from repro_torch.models.sharded_ssm import ssm_mixer

        cfg, lp = self.cfg, [local_tree(p, i) for i in range(self.n)]
        hs = [rms_norm(x, lp[i]["norm1"]) for i, x in enumerate(xs)]
        if kind.mixer == "attn":
            mix, new = self.attn(kind, p["attn"], hs, positions, pos3, mode, caches)
        else:
            mix, new = ssm_mixer(self, p["ssm"], hs, mode, caches)
        if cfg.sandwich_norm:
            mix = [rms_norm(t, lp[i]["post_norm1"]) for i, t in enumerate(mix)]
        xs = [x + t for x, t in zip(xs, mix)]
        aux = None
        if kind.moe or cfg.d_ff > 0:
            hs = [rms_norm(x, lp[i]["norm2"]) for i, x in enumerate(xs)]
            if kind.moe:
                ff, aux = moe(self, p["moe"], hs)
            else:
                ff = self.mlp(p["mlp"], hs, MLPConfig(cfg.d_model, cfg.d_ff, cfg.act))
            if cfg.sandwich_norm:
                ff = [rms_norm(t, lp[i]["post_norm2"]) for i, t in enumerate(ff)]
            xs = [x + t for x, t in zip(xs, ff)]
        return xs, new, aux

    def scan(self, params, xs, positions, pos3, mode, caches):
        """The repeat groups in order; the group's leaves are gathered inside
        its body.  ``caches``: per shard, the local stacked decode caches
        (written in place).  Returns (xs, {pos: per group, per shard new
        cache}, per-shard aux: the sum of the MoE blocks' aux)."""
        cfg, pattern, ng, n = self.cfg, layer_pattern(self.cfg), n_groups(self.cfg), self.n
        groups = _layers(params["blocks"], ng)
        per_shard = None if caches is None else [unstack(c, ng) for c in caches]
        new = {f"pos{i}": [] for i in range(len(pattern))}
        aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
        for g in range(ng):

            def body(*xs, bp=groups[g], g=g):
                bp = tree_map(_group_layout, bp)
                xs = list(xs)
                aux_g = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
                for i, kind in enumerate(pattern):
                    ci = None if per_shard is None else [c[g][f"pos{i}"] for c in per_shard]
                    xs, nc, a = self.block(kind, bp[f"pos{i}"], xs, positions, pos3, mode, ci)
                    if a is not None:
                        aux_g = [u + v for u, v in zip(aux_g, a)]
                    new[f"pos{i}"].append(nc)
                return (*xs, *aux_g)

            if mode == "train" and cfg.remat == "block" and torch.is_grad_enabled():
                out = checkpoint(body, *xs, use_reentrant=False)
            else:
                out = body(*xs)
            xs = list(out[:n])
            aux = [u + v for u, v in zip(aux, out[n:])]
        return xs, new, aux

    # -- embedding and head ----------------------------------------------
    def embed(self, E: Sharded, tokens: list, vision: list | None = None) -> list:
        """Vocab-parallel lookup: each shard takes the rows it holds, zeros
        elsewhere, and the all-reduce adds exact zeros -- the one-device bits.
        The VLM's patch embeddings (``vision``, per batch shard) go first."""
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
        dt = self.cfg.compute_dtype
        h = [r.to(dt) for r in rows]
        if getattr(self.cfg, "embed_scale", False):  # Whisper has none
            h = [x * torch.tensor(self.cfg.d_model**0.5, dtype=dt, device=x.device) for x in h]
        if vision is not None:
            h = [torch.cat([v.to(dt), x], dim=1) for v, x in zip(vision, h)]
        return h

    def pos3(self, placed: Sharded | None, xs: list) -> list | None:
        """M-RoPE positions per shard: the placed ``positions3`` blocks, else
        every component the arange (``transformer._default_pos3``)."""
        if not self.cfg.mrope:
            return None
        if placed is not None:
            return list(placed.shards)
        return [_default_pos3(self.cfg, x, None) for x in xs]

    def head_logits(self, h, head) -> torch.Tensor:
        """f32 logits of normed ``h`` against a head block [D, V_local]."""
        return _head_logits(self.cfg, h, head)

    def heads(self, top) -> tuple[list, bool]:
        """Each shard's head block [D, V_local] and whether it is vocab-split."""
        if getattr(self.cfg, "tie_embeddings", True):  # Whisper's head is its embedding
            E = top["embed"]
            return [t.T for t in E.shards], _model_dim(E) == 0
        H = top["lm_head"]
        return list(H.shards), _model_dim(H) == 1

    def logits(self, top, xs) -> torch.Tensor:
        """The last position's f32 logits [B, 1, V], whole on the first device."""
        heads, split = self.heads(top)
        fn = top["final_norm"]
        out = [self.head_logits(rms_norm(x, fn.shards[i]), heads[i]) for i, x in enumerate(xs)]
        return self.whole_logits(out, split)

    def whole_logits(self, out: list, split: bool) -> torch.Tensor:
        """Per-shard logit blocks [B_l, 1, V_l] whole on the first device."""
        spec = P(self.batch_spec, None, "model" if split else None)
        return Sharded.from_local(out, self.mesh, spec).full()

    def ce_totals(self, top, hs: list, targets: list) -> list:
        """Each shard's summed token log-likelihoods, negated (``_chunked_ce``'s
        total before the division), over 512-token chunks."""
        heads, split = self.heads(top)
        S = hs[0].shape[1]
        chunk = _ce_chunk(S, 512)
        totals = [torch.zeros((), dtype=torch.float32, device=h.device) for h in hs]
        for c in range(0, S, chunk):
            lg = [self.head_logits(h[:, c : c + chunk], hd) for h, hd in zip(hs, heads)]
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


def _placed(mesh, batch: dict) -> dict:
    """The batch inputs as ``input_pspecs`` places them (the batch on dim 0,
    ``positions3``'s on dim 1); a global tensor is placed here, ``None``
    dropped."""
    from repro_torch.models.registry import _batch_axes

    out = {}
    for k, x in batch.items():
        if x is None or isinstance(x, Sharded):
            if x is not None:
                out[k] = x
            continue
        if k == "positions3":
            spec = P(None, _batch_axes(mesh, x.shape[1]), None)
        else:
            spec = P(_batch_axes(mesh, x.shape[0]), *(None,) * (x.dim() - 1))
        out[k] = shard(x, NamedSharding(mesh, spec))
    return out


def seq_axis_of(caches):
    """The mesh axis of the attention caches' sequence (dim 2 of a stacked
    ``k``), or None: ``cache_pspecs(..., shard_seq=True)``'s ``data``."""
    for c in caches.values():
        if "k" in c:
            return c["k"].spec[2]
    return None  # SSM caches only: no sequence axis


def _representatives(mesh, batch_spec) -> list[int]:
    """One shard per distinct batch block: the one at 0 on every other axis."""
    keep = set(axis_names_of(batch_spec))
    return [
        i for i in range(mesh.size)
        if all(v == 0 for a, v in mesh.coord(i).items() if a not in keep)
    ]


def _start(cfg, params, batch: dict):
    """The run, the placed batch, the head leaves and the embedded inputs."""
    b = _placed(_mesh_of(params), batch)
    run = _Run(cfg, params, b["tokens"].spec[0])
    top = run.top(params)
    vis = b.get("vision_embeds")
    xs = run.embed(top["embed"], b["tokens"].shards, None if vis is None else vis.shards)
    return run, b, top, xs


def lm_loss(cfg: ModelConfig, params, batch: dict):
    """``transformer.lm_loss`` over the mesh of ``params``' sharded leaves."""
    run, b, top, xs = _start(cfg, params, batch)
    targets = b["targets"]
    positions = [torch.arange(x.shape[1], device=x.device) for x in xs]
    xs, _, aux = run.scan(params, xs, positions, run.pos3(b.get("positions3"), xs), "train", None)
    T = targets.shape[1]
    hs = [rms_norm(x, top["final_norm"].shards[i])[:, -T:] for i, x in enumerate(xs)]
    totals = run.ce_totals(top, hs, targets.shards)
    dev = run.mesh.flat[0]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for i in run.reps:
        total = total + totals[i].to(dev)
    ce = total / (targets.shape[0] * T)
    # every shard holds the aux of the global batch: take it once
    aux = aux[0].to(dev)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(cfg: ModelConfig, params, tokens, *, pos3=None, vision_embeds=None):
    """``transformer.prefill`` over the mesh: (logits [B, 1, V] whole on the
    mesh's first device, caches sharded by ``cache_pspecs``)."""
    run, b, top, xs = _start(
        cfg, params, {"tokens": tokens, "positions3": pos3, "vision_embeds": vision_embeds}
    )
    positions = [torch.arange(x.shape[1], device=x.device) for x in xs]
    xs, new, _ = run.scan(params, xs, positions, run.pos3(b.get("positions3"), xs), "prefill", None)
    specs = cache_specs(cfg, run.batch_spec, run.kv_axis)
    caches = {
        pos: {
            name: Sharded.from_local(
                [torch.stack([grp[i][name] for grp in per_group]) for i in range(run.n)], run.mesh, spec
            )
            for name, spec in specs[pos].items()
        }
        for pos, per_group in new.items()
    }
    return run.logits(top, [x[:, -1:] for x in xs]), caches


def decode_step(cfg: ModelConfig, params, caches, tokens, cur_len):
    """``transformer.decode_step`` over the mesh: each shard appends to its
    blocks of the sharded ``caches`` in place; returns (logits whole on the
    mesh's first device, caches)."""
    run, b, top, xs = _start(cfg, params, {"tokens": tokens, "cur_len": cur_len})
    run.seq_axis = seq_axis_of(caches)
    positions = [c[:, None] for c in b["cur_len"].shards]
    pos3 = [p[None].expand(3, *p.shape) for p in positions] if cfg.mrope else None
    local_caches = [local_tree(caches, i) for i in range(run.n)]
    xs, _, _ = run.scan(params, xs, positions, pos3, "decode", local_caches)
    return run.logits(top, xs), caches
