"""Whisper over a named mesh: what XLA's SPMD partitioner makes of JAX's
specs for ``models/whisper.py`` (the template's ``(FSDP, TP)`` /
``(TP, FSDP)`` leaves, ``input_pspecs``, ``cache_pspecs``), run shard by
shard through the pieces of :mod:`repro_torch.models.sharded`:

* every leaf is all-gathered over ``data`` (FSDP) a layer at a time;
  autograd reduce-scatters the gradients back.  LayerNorm parameters are
  used whole;
* ``wq`` / ``wk`` / ``wv`` column-parallel with local heads, ``wo`` and
  the GELU MLP's ``w_down`` row-parallel and all-reduced over ``model``.
  Where the heads do not divide over ``model`` (the cache specs replicate
  there), Q / K / V are all-gathered and every model shard attends all
  heads;
* the encoder runs on each batch shard's frames; from 4096 frames on,
  prefill attends through ``attend_chunked`` (the ``flash_attention``
  kernel on the card) on each shard's heads, training through the plain
  query-chunked code, as on one device;
* the decoder's self-attention is causal in training; decode appends to
  the self cache (batch x heads split) in place.  Cross-attention takes K
  / V from each batch shard's encoder states in training and reads the
  cross cache in decode -- with its sequence over ``data``
  (``shard_seq``), by ``sharded._Run.seq_attend``'s two-pass softmax;
* a vocab-parallel ``embed`` (a masked lookup and an all-reduce, exact),
  ``dec_pos`` gathered, the tied f32 head split over the vocab: the loss
  combines the max and log-sum-exp across ``model`` in f32 and adds each
  batch block's token losses once; decode's logits come back whole on the
  mesh's first device.
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import qdot, tree_map
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.distributed.spmd import Sharded, local, local_tree
from repro_torch.models.attention import AttnMask, KVCache, decode_attend
from repro_torch.models.common import unstack
from repro_torch.models.sharded import _layers, _mesh_of, _model_dim, _placed, _Run, _tp_layout
from repro_torch.models.whisper import (
    WhisperConfig,
    _attention,
    _ln,
    _mlp_cfg,
    _sinusoids,
    whisper_cache_specs,
)

__all__ = ["whisper_loss", "whisper_prefill", "whisper_decode_step"]


class _WhisperRun(_Run):
    """One sharded Whisper pass: the mesh's fields of :class:`_Run`, the
    heads each shard attends, and the encoder and decoder stacks."""

    def __init__(self, cfg: WhisperConfig, params, batch_spec):
        self.on_mesh(cfg, params, batch_spec, cfg.n_heads)
        self.heads_local = self.tp > 1 and self.kv_axis is not None
        attn = params["enc_blocks"]["attn"]
        if self.heads_local and any(_model_dim(attn[w]) != 2 for w in ("wq", "wk", "wv")):
            raise ValueError("the heads divide over 'model' but wq / wk / wv are not split")
        # the heads of a cache block: split over model where the specs split them
        self.cache_heads = cfg.n_heads // (self.tp if self.kv_axis == "model" else 1)

    def head_logits(self, h, head) -> torch.Tensor:
        return torch.matmul(h.to(torch.float32), head.to(torch.float32))

    def top(self, params) -> dict:
        return {k: _gathered(params[k]) for k in ("embed", "dec_pos", "enc_norm", "dec_norm")}

    def split_heads(self, ts: list) -> list:
        """[B, S, heads * d_head] -> [B, S, heads, d_head] per shard."""
        return [t.reshape(*t.shape[:2], -1, self.cfg.d_head) for t in ts]

    def columns(self, p, xs: list, w: str) -> list:
        """``x @ w`` per shard: a column-split ``w`` gives local heads, which
        are all-gathered where the heads are not local."""
        out = [qdot(x, local(p[w], i)) for i, x in enumerate(xs)]
        if not self.heads_local and _model_dim(p[w]) == 1:
            out = self.gather(out)
        return self.split_heads(out)

    def mha(self, p, xq: list, xkv: list | None, causal: bool, train: bool) -> list:
        """Full-sequence MHA: self-attention (``xkv`` None) or cross-attention."""
        xkv = xq if xkv is None else xkv
        q, k, v = self.columns(p, xq, "wq"), self.columns(p, xkv, "wk"), self.columns(p, xkv, "wv")
        outs = [
            _attention(a, b, c, AttnMask(causal=causal), train).flatten(2) for a, b, c in zip(q, k, v)
        ]
        return self.row(outs, self.heads_local, p["wo"])

    def mlp_block(self, p, lp: list, hs: list, norm: str) -> list:
        ff = self.mlp(p["mlp"], [_ln(h, lp[i][norm]) for i, h in enumerate(hs)], _mlp_cfg(self.cfg))
        return [h + f for h, f in zip(hs, ff)]

    def encode(self, params, top, frames: list, train: bool) -> list:
        """``whisper_encode`` on each batch shard's frames."""
        cfg = self.cfg
        hs = [f.to(cfg.compute_dtype) for f in frames]
        hs = [h + _sinusoids(h.shape[1], cfg.d_model, h.device).to(h.dtype)[None] for h in hs]
        for p in _layers(params["enc_blocks"], cfg.n_enc_layers):
            p = _gathered(p)
            lp = [local_tree(p, i) for i in range(self.n)]
            a = self.mha(p["attn"], [_ln(h, lp[i]["norm1"]) for i, h in enumerate(hs)], None, False, train)
            hs = self.mlp_block(p, lp, [h + t for h, t in zip(hs, a)], "norm2")
        return [_ln(h, local_tree(top["enc_norm"], i)) for i, h in enumerate(hs)]

    def decode_attn(self, p, xs: list, caches: list, seq_split: bool) -> list:
        """One token against each shard's cache (per shard a layer's block)."""
        qs = self.columns(p, xs, "wq")
        if seq_split:
            outs = self.seq_attend(qs, caches)
        else:
            outs = [decode_attend(q, c) for q, c in zip(qs, caches)]
        return self.row([o.flatten(2) for o in outs], self.heads_local, p["wo"])

    def decoder(self, params, hs: list, enc: list | None, caches: list | None) -> list:
        """Train (``caches`` None: causal self-attention, cross-attention on
        ``enc``) or decode (``caches``: per shard, the local stacked caches;
        the self caches appended in place)."""
        cfg = self.cfg
        layer_caches = None if caches is None else [unstack(c, cfg.n_dec_layers) for c in caches]
        for li, p in enumerate(_layers(params["dec_blocks"], cfg.n_dec_layers)):
            p = _gathered(p)
            lp = [local_tree(p, i) for i in range(self.n)]
            x = [_ln(h, lp[i]["norm1"]) for i, h in enumerate(hs)]
            if caches is None:
                a = self.mha(p["self_attn"], x, None, True, True)
                hs = [h + t for h, t in zip(hs, a)]
                x2 = [_ln(h, lp[i]["norm2"]) for i, h in enumerate(hs)]
                c = self.mha(p["cross_attn"], x2, enc, False, True)
            else:
                lc = [per[li] for per in layer_caches]
                ks, vs = self.columns(p["self_attn"], x, "wk"), self.columns(p["self_attn"], x, "wv")
                selfc = [KVCache.append_one(c["self"], k, v) for c, k, v in zip(lc, ks, vs)]
                a = self.decode_attn(p["self_attn"], x, selfc, False)
                hs = [h + t for h, t in zip(hs, a)]
                x2 = [_ln(h, lp[i]["norm2"]) for i, h in enumerate(hs)]
                c = self.decode_attn(p["cross_attn"], x2, [c["cross"] for c in lc], self.seq_axis is not None)
            hs = self.mlp_block(p, lp, [h + t for h, t in zip(hs, c)], "norm3")
        return hs

    def normed(self, top, hs: list) -> list:
        return [_ln(h, local_tree(top["dec_norm"], i)) for i, h in enumerate(hs)]



def _gathered(tree):
    """Every leaf of ``tree`` gathered over the axes but ``model`` (FSDP's
    gather before use)."""
    return tree_map(lambda _, t: _tp_layout(t), tree)


def _embedded(run: _WhisperRun, top, tokens: list, pos: list) -> list:
    """Token embeddings plus the learned decoder positions ``pos`` (per
    shard: [T] or [B_l, 1])."""
    xs = run.embed(top["embed"], tokens)
    table = [local(top["dec_pos"], i) for i in range(run.n)]
    return [x + table[i][p].to(x.dtype) for i, (x, p) in enumerate(zip(xs, pos))]


def whisper_loss(cfg: WhisperConfig, params, batch):
    """``whisper.whisper_loss`` over the mesh of ``params``' sharded leaves."""
    b = _placed(_mesh_of(params), batch)
    run = _WhisperRun(cfg, params, b["tokens"].spec[0])
    top = run.top(params)
    enc = run.encode(params, top, b["audio_frames"].shards, train=True)
    T = b["tokens"].shape[1]
    xs = _embedded(run, top, b["tokens"].shards, [torch.arange(T, device=x.device)[None] for x in enc])
    xs = run.decoder(params, xs, enc, None)
    totals = run.ce_totals(top, run.normed(top, xs), b["targets"].shards)
    dev = run.mesh.flat[0]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for i in run.reps:
        total = total + totals[i].to(dev)
    ce = total / (b["targets"].shape[0] * T)
    return ce, {"ce": ce}


def whisper_prefill(cfg: WhisperConfig, params, frames, *, shard_seq: bool = False):
    """``whisper.whisper_prefill`` over the mesh: the caches sharded by
    ``cache_pspecs`` (``shard_seq``: each shard keeps its ``data`` block of
    the cross cache's sequence), the self caches zeros."""
    mesh = _mesh_of(params)
    b = _placed(mesh, {"audio_frames": frames})
    run = _WhisperRun(cfg, params, b["audio_frames"].spec[0])
    seq = "data" if shard_seq and "data" in mesh.axis_names else None
    specs = whisper_cache_specs(run.batch_spec, run.kv_axis, seq)
    tree_map(lambda _, s: NamedSharding(mesh, s), specs)  # a duplicated axis raises, as in JAX
    enc = run.encode(params, run.top(params), b["audio_frames"].shards, train=False)
    Se = enc[0].shape[1]
    n_seq = mesh.axis_size(seq)
    cross = {"k": [[] for _ in enc], "v": [[] for _ in enc]}
    for p in _layers(params["dec_blocks"], cfg.n_dec_layers):
        p = _gathered(p)
        for name, w in (("k", "wk"), ("v", "wv")):
            for i, t in enumerate(run.columns(p["cross_attn"], enc, w)):
                blk = mesh.block_index(i, seq) * (Se // n_seq)
                cross[name][i].append(t.narrow(1, blk, Se // n_seq).to(cfg.compute_dtype))
    L = cfg.n_dec_layers
    out = {"cross": {}, "self": {}}
    for name in ("k", "v"):
        out["cross"][name] = [torch.stack(c) for c in cross[name]]
        out["self"][name] = [
            torch.zeros((L, e.shape[0], cfg.dec_max_len, run.cache_heads, cfg.d_head),
                        dtype=cfg.compute_dtype, device=e.device)
            for e in enc
        ]
    for part, n0 in (("cross", Se), ("self", 0)):
        out[part]["len"] = [torch.full((L, e.shape[0]), n0, dtype=torch.int32, device=e.device) for e in enc]
    return {
        part: {name: Sharded.from_local(ts, mesh, specs[part][name]) for name, ts in c.items()}
        for part, c in out.items()
    }


def whisper_decode_step(cfg: WhisperConfig, params, caches, tokens, cur_len):
    """``whisper.whisper_decode_step`` over the mesh: each shard appends to
    its block of the self cache in place; returns (logits [B, 1, V] whole
    on the mesh's first device, caches)."""
    b = _placed(_mesh_of(params), {"tokens": tokens, "cur_len": cur_len})
    run = _WhisperRun(cfg, params, b["tokens"].spec[0])
    run.seq_axis = caches["cross"]["k"].spec[2]
    top = run.top(params)
    pos = [torch.clamp(c.to(torch.int64), 0, cfg.dec_max_len - 1)[:, None] for c in b["cur_len"].shards]
    xs = _embedded(run, top, b["tokens"].shards, pos)
    xs = run.decoder(params, xs, None, [local_tree(caches, i) for i in range(run.n)])
    heads, split = run.heads(top)
    out = [run.head_logits(h, hd) for h, hd in zip(run.normed(top, xs), heads)]
    return run.whole_logits(out, split), caches
