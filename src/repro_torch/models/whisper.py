"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Port of ``repro/models/whisper.py``.  The conv frontend is a stub, as in
JAX: the encoder takes precomputed mel-frame *embeddings* [B, S_enc,
d_model] (what the two conv layers would emit).  The transformer backbone
is complete: bidirectional encoder, causal decoder with cross-attention,
learned decoder positions, sinusoidal encoder positions, LayerNorm + GELU
(tanh approximation, as ``jax.nn.gelu``).

Decode shapes: the decoder context is capped at ``dec_max_len`` (448), so
the 32k of ``decode_32k`` applies to the *encoder* context; ``long_500k``
is skipped (full-attention encoder).

Layers are stacked over a leading axis, as in JAX; JAX's ``scan`` over
them becomes a Python loop over :func:`~repro_torch.models.common.unstack`'s
per-layer views.  JAX's ``constrain`` calls are dropped: on one device
they do nothing.  Parameters placed on a mesh (``launch/steps.py``) run
sharded (``models/sharded_whisper.py``): ``whisper_loss``,
``whisper_prefill`` and ``whisper_decode_step`` dispatch there.
Attention from 4096 queries on goes through
``attend_chunked`` (the ``flash_attention`` kernel on the card) outside
training, and through the plain query-chunked code in training, as JAX
trains through no Pallas kernel.  Decode appends each layer's K/V to the
self cache in place and leaves the cross cache as it is.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.precision import qdot, tree_map
from repro_torch.distributed.sharding import P
from repro_torch.distributed.spmd import is_sharded
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import AttnMask, KVCache
from repro_torch.models.common import FSDP, TP, dense, layer_norm, unstack
from repro_torch.models.mlp import MLPConfig, mlp_apply, mlp_template

__all__ = [
    "WhisperConfig",
    "whisper_template",
    "whisper_forward",
    "whisper_loss",
    "whisper_encode",
    "whisper_prefill",
    "whisper_decode_step",
    "whisper_cache_template",
    "whisper_cache_specs",
]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """The JAX package's ``WhisperConfig``, field for field; ``compute_dtype`` is a torch dtype."""

    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    dec_max_len: int = 448
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def _mlp_cfg(cfg: WhisperConfig) -> MLPConfig:
    return MLPConfig(cfg.d_model, cfg.d_ff, "gelu")


def _norm_t(d):
    return {"w": dense(d, init="ones"), "b": dense(d, init="zeros")}


def _attn_t(cfg: WhisperConfig) -> dict:
    d = cfg.d_model
    return {
        "wq": dense(d, d, logical=(FSDP, TP)),
        "wk": dense(d, d, logical=(FSDP, TP)),
        "wv": dense(d, d, logical=(FSDP, TP)),
        "wo": dense(d, d, logical=(TP, FSDP)),
    }


def _enc_block_t(cfg):
    return {
        "norm1": _norm_t(cfg.d_model),
        "attn": _attn_t(cfg),
        "norm2": _norm_t(cfg.d_model),
        "mlp": mlp_template(_mlp_cfg(cfg)),
    }


def _dec_block_t(cfg):
    return {
        "norm1": _norm_t(cfg.d_model),
        "self_attn": _attn_t(cfg),
        "norm2": _norm_t(cfg.d_model),
        "cross_attn": _attn_t(cfg),
        "norm3": _norm_t(cfg.d_model),
        "mlp": mlp_template(_mlp_cfg(cfg)),
    }


def _stack(template, n: int):
    """Prepend the layer axis (unsharded) to every leaf spec."""
    return tree_map(
        lambda _, s: dataclasses.replace(
            s, shape=(n, *s.shape), logical=(None, *(s.logical or (None,) * len(s.shape)))
        ),
        template,
    )


def whisper_template(cfg: WhisperConfig) -> dict:
    return {
        "embed": dense(cfg.vocab, cfg.d_model, logical=(TP, FSDP), scale=0.02),
        "dec_pos": dense(cfg.dec_max_len, cfg.d_model, logical=(None, FSDP), scale=0.02),
        "enc_blocks": _stack(_enc_block_t(cfg), cfg.n_enc_layers),
        "dec_blocks": _stack(_dec_block_t(cfg), cfg.n_dec_layers),
        "enc_norm": _norm_t(cfg.d_model),
        "dec_norm": _norm_t(cfg.d_model),
    }


def _sinusoids(length: int, channels: int, device) -> torch.Tensor:
    """Whisper's sinusoidal encoder positions [length, channels] on ``device``, in f32 as JAX computes them."""
    f32 = dict(dtype=torch.float32, device=device)
    log_timescale = torch.tensor(math.log(10_000.0), **f32) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, **f32))
    ang = torch.arange(length, **f32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _ln(h, p):
    return layer_norm(h, p["w"], p["b"])


def _heads(cfg, t):
    return t.reshape(t.shape[0], t.shape[1], cfg.n_heads, cfg.d_head)


def _attention(q, k, v, mask: AttnMask, train: bool):
    """Full-sequence attention [B, Sq, H, d_head]: plain below 4096 queries,
    else ``attend_chunked`` (the kernel on the card) or, in training, the
    plain query-chunked code (the kernel has no backward; JAX trains
    through no Pallas kernel)."""
    if q.shape[1] < 4096:
        attend_fn = attn_lib.attend
    elif train:
        attend_fn = attn_lib.attend_query_chunked
    else:
        attend_fn = attn_lib.attend_chunked
    return attend_fn(q, k, v, mask=mask)


def _mha(cfg, p, xq, xkv, mask: AttnMask, train: bool):
    """Full-sequence MHA: self-attention (``xkv`` None) or cross-attention."""
    B, Sq, D = xq.shape
    xkv = xq if xkv is None else xkv
    q, k, v = (_heads(cfg, qdot(x, p[w])) for x, w in ((xq, "wq"), (xkv, "wk"), (xkv, "wv")))
    return qdot(_attention(q, k, v, mask, train).reshape(B, Sq, D), p["wo"])


def _decode_mha(cfg, p, x, cache):
    """One query token against a KV cache."""
    q = _heads(cfg, qdot(x, p["wq"]))
    out = attn_lib.decode_attend(q, cache)
    return qdot(out.reshape(x.shape), p["wo"])


def whisper_encode(cfg: WhisperConfig, params, frames, *, train: bool = False):
    """frames [B, S_enc, D] (precomputed conv-frontend output) -> encoder states.

    ``train`` keeps the attention differentiable from 4096 frames on (the
    plain query-chunked code instead of the forward-only kernel)."""
    h = frames.to(cfg.compute_dtype)
    h = h + _sinusoids(h.shape[1], cfg.d_model, h.device).to(h.dtype)[None]
    mlp = _mlp_cfg(cfg)
    for p in unstack(params["enc_blocks"], cfg.n_enc_layers):
        h = h + _mha(cfg, p["attn"], _ln(h, p["norm1"]), None, AttnMask(causal=False), train)
        h = h + mlp_apply(mlp, p["mlp"], _ln(h, p["norm2"]))
    return _ln(h, params["enc_norm"])


def _decode_blocks(cfg, params, h, enc_out, caches=None):
    """Train (``caches`` None: full sequence, causal self-attention, cross-
    attention on ``enc_out``) or decode (one token against each layer's
    caches; the self caches are appended to in place)."""
    layers = unstack(params["dec_blocks"], cfg.n_dec_layers)
    layer_caches = [None] * cfg.n_dec_layers if caches is None else unstack(caches, cfg.n_dec_layers)
    mlp = _mlp_cfg(cfg)
    for p, cache in zip(layers, layer_caches):
        x = _ln(h, p["norm1"])  # JAX computes it three times in decode: the same bits
        if cache is None:
            h = h + _mha(cfg, p["self_attn"], x, None, AttnMask(causal=True), True)
            h = h + _mha(cfg, p["cross_attn"], _ln(h, p["norm2"]), enc_out, AttnMask(causal=False), True)
        else:
            self_cache = KVCache.append_one(
                cache["self"], _heads(cfg, qdot(x, p["self_attn"]["wk"])),
                _heads(cfg, qdot(x, p["self_attn"]["wv"])),
            )
            h = h + _decode_mha(cfg, p["self_attn"], x, self_cache)
            h = h + _decode_mha(cfg, p["cross_attn"], _ln(h, p["norm2"]), cache["cross"])
        h = h + mlp_apply(mlp, p["mlp"], _ln(h, p["norm3"]))
    return h


def _logits(params, h):
    h = _ln(h, params["dec_norm"])
    return torch.einsum("bsd,vd->bsv", h.to(torch.float32), params["embed"].to(torch.float32))


def _embed(cfg, params, tokens):
    # index first, then cast: the same values as casting the whole table first
    return params["embed"][tokens].to(cfg.compute_dtype)


def whisper_forward(cfg: WhisperConfig, params, frames, tokens):
    """Training forward -> logits [B, S_dec, V] (f32)."""
    enc_out = whisper_encode(cfg, params, frames, train=True)
    h = _embed(cfg, params, tokens)
    h = h + params["dec_pos"][: tokens.shape[1]].to(h.dtype)[None]
    return _logits(params, _decode_blocks(cfg, params, h, enc_out))


def whisper_loss(cfg: WhisperConfig, params, batch):
    """Mean next-token cross-entropy over the whole vocab -> (loss, {"ce": loss})."""
    if is_sharded(params["embed"]):
        from repro_torch.models import sharded_whisper

        return sharded_whisper.whisper_loss(cfg, params, batch)
    logits = whisper_forward(cfg, params, batch["audio_frames"], batch["tokens"])
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["targets"].to(torch.int64)[..., None])[..., 0]
    ce = -torch.mean(ll)
    return ce, {"ce": ce}


def whisper_cache_template(cfg: WhisperConfig, batch: int, enc_len: int):
    """{"self" | "cross": {name: (shape, dtype)}} of the decode caches,
    stacked over the decoder layers: the self cache ``dec_max_len`` deep,
    the cross cache ``enc_len``."""
    one = {
        "self": KVCache.template(batch, cfg.dec_max_len, cfg.n_heads, cfg.d_head, cfg.compute_dtype),
        "cross": KVCache.template(batch, enc_len, cfg.n_heads, cfg.d_head, cfg.compute_dtype),
    }
    return tree_map(lambda _, s: ((cfg.n_dec_layers, *s[0]), s[1]), one)


def whisper_cache_specs(batch_axes, tp_axis, seq_axis=None) -> dict:
    """Partition specs matching :func:`whisper_cache_template`: K / V
    [layers, batch, seq, heads, d_head] over the batch axes, ``seq_axis``
    (the cross cache only) and ``tp_axis``; ``len`` over the batch."""
    kv = lambda s: {
        "k": P(None, batch_axes, s, tp_axis, None),
        "v": P(None, batch_axes, s, tp_axis, None),
        "len": P(None, batch_axes),
    }
    return {"self": kv(None), "cross": kv(seq_axis)}


def whisper_prefill(cfg: WhisperConfig, params, frames, *, shard_seq: bool = False):
    """Encode audio and precompute every decoder layer's cross-attention K/V.

    Returns the caches of :func:`whisper_cache_template`: the cross cache
    filled (``len`` = S_enc), the self cache zeros with ``len`` 0, each
    layer's its own storage (decode appends in place).  Parameters placed
    on a mesh run sharded and return caches sharded by ``cache_pspecs``
    (``shard_seq``: the cross cache's sequence over ``data``; on one device
    it changes nothing)."""
    if is_sharded(params["embed"]):
        from repro_torch.models import sharded_whisper

        return sharded_whisper.whisper_prefill(cfg, params, frames, shard_seq=shard_seq)
    enc_out = whisper_encode(cfg, params, frames)
    B, Se, _ = enc_out.shape
    t = whisper_cache_template(cfg, B, Se)
    dev = enc_out.device
    self_cache = {name: torch.zeros(s, dtype=dt, device=dev) for name, (s, dt) in t["self"].items()}
    cross = {name: torch.empty(s, dtype=dt, device=dev) for name, (s, dt) in t["cross"].items()}
    for i, p in enumerate(unstack(params["dec_blocks"], cfg.n_dec_layers)):
        cross["k"][i] = _heads(cfg, qdot(enc_out, p["cross_attn"]["wk"]))
        cross["v"][i] = _heads(cfg, qdot(enc_out, p["cross_attn"]["wv"]))
    cross["len"].fill_(Se)
    return {"self": self_cache, "cross": cross}


def whisper_decode_step(cfg: WhisperConfig, params, caches, tokens, cur_len):
    """One decoder token against the self and cross caches. tokens [B, 1];
    cur_len [B] -> (logits [B, 1, V] f32, caches, the self caches appended
    in place).  Parameters placed on a mesh run sharded against caches
    sharded by ``cache_pspecs``; the logits come back whole."""
    if is_sharded(params["embed"]):
        from repro_torch.models import sharded_whisper

        return sharded_whisper.whisper_decode_step(cfg, params, caches, tokens, cur_len)
    h = _embed(cfg, params, tokens)
    pos = torch.clamp(cur_len.to(torch.int64), 0, cfg.dec_max_len - 1)
    h = h + params["dec_pos"][pos][:, None, :].to(h.dtype)
    h = _decode_blocks(cfg, params, h, None, caches)
    return _logits(params, h), caches
