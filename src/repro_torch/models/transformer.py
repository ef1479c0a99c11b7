"""The unified decoder LM: dense, MoE, SSM, hybrid and VLM families.

Port of ``repro/models/transformer.py``.  A model is a repeating *pattern*
of blocks (jamba: 1 attention + 7 SSD mixers per period, MoE on every 2nd
layer; gemma2: alternating local / global attention); parameters of each
pattern position are stacked over the repeat-group axis, and the JAX
``lax.scan`` over groups becomes a Python loop that indexes the stacked
leaves.

Three execution modes share one block implementation:
  * train    -- full-sequence, no cache (:func:`forward`, :func:`lm_loss`)
  * prefill  -- full-sequence, emits exact-length KV caches and the SSM
                blocks' conv / state caches
  * decode   -- one token against preallocated caches, written in place

Train mode runs the plain attention on every device, as JAX trains through
no Pallas kernel: :func:`~repro_torch.models.attention.attend` below 4096
tokens, the query-chunked plain code at 4096 and more.  Prefill at 4096
tokens and more launches the forward-only ``flash_attention`` kernel on
the card.  ``remat="block"`` recomputes each repeat group in the backward
pass (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``).

The VLM takes precomputed patch embeddings (``vision_embeds``, prepended to
the token embeddings) and M-RoPE positions ``pos3`` [3, B, S] (t, h, w).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.core.precision import qdot, tree_map
from repro_torch.distributed.sharding import P
from repro_torch.distributed.spmd import is_sharded
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import AttnMask, KVCache
from repro_torch.models.common import FSDP, TP, dense, rms_norm, unstack
from repro_torch.models.mamba2 import (
    SSMConfig,
    ssm_apply,
    ssm_cache_template,
    ssm_decode_step,
    ssm_template,
)
from repro_torch.models.mlp import (
    MLPConfig,
    MoEConfig,
    mlp_apply,
    mlp_template,
    moe_apply,
    moe_template,
)

__all__ = [
    "ModelConfig",
    "BlockKind",
    "layer_pattern",
    "n_groups",
    "model_template",
    "forward",
    "lm_loss",
    "prefill",
    "decode_step",
    "cache_template",
    "cache_specs",
    "cache_init",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's ``ModelConfig``, field for field; ``compute_dtype`` is a torch dtype."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "swiglu"
    rope_theta: float = 10_000.0
    rope_frac: float = 1.0  # stablelm applies rotary to 25% of head dims
    mrope: bool = False
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    window: int | None = None  # sliding-window size for "local" layers
    local_global_period: int = 0  # gemma2: 2 -> alternate local/global
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    sandwich_norm: bool = False  # gemma2 post-norms
    embed_scale: bool = False  # gemma2 multiplies embeddings by sqrt(d)
    tie_embeddings: bool = True
    qkv_bias: bool = False  # qwen2 family
    moe: MoEConfig | None = None
    moe_period: int = 1
    ssm: SSMConfig | None = None
    attn_period: int = 0  # hybrid: 0 = all-attention; k = attn every k-th; -1 = none
    remat: str = "none"  # none | block; training only, no effect on prefill / decode
    compute_dtype: torch.dtype = torch.bfloat16
    shard_head_dim: bool = True  # FSDP-shard embed / lm_head's d_model axis; sharding only
    kv_cache_bits: int | None = None  # 8 = int8 KV cache
    kv_scale: float = 32.0
    gqa_flat: bool = False  # repeat KV heads to n_heads before prefill attention

    @property
    def attention_free(self) -> bool:
        return self.attn_period == -1


@dataclasses.dataclass(frozen=True)
class BlockKind:
    mixer: str  # "attn" | "ssm"
    window: int | None
    moe: bool


def layer_pattern(cfg: ModelConfig) -> tuple[BlockKind, ...]:
    """The repeating block pattern; its length divides n_layers."""
    period = 1
    if cfg.attn_period > 0:
        period = max(period, cfg.attn_period)
    if cfg.local_global_period:
        period = max(period, cfg.local_global_period)
    if cfg.moe is not None and cfg.moe_period > 1:
        period = math.lcm(period, cfg.moe_period)
    kinds = []
    for i in range(period):
        if cfg.attention_free:
            mixer = "ssm"
        elif cfg.attn_period > 0:
            mixer = "attn" if i % cfg.attn_period == 0 else "ssm"
        else:
            mixer = "attn"
        window = None
        if cfg.local_global_period and i % cfg.local_global_period == 0:
            window = cfg.window  # even positions local (gemma2 ordering)
        moe = cfg.moe is not None and (i % cfg.moe_period == 0 if cfg.moe_period > 1 else True)
        kinds.append(BlockKind(mixer=mixer, window=window, moe=moe))
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} not divisible by pattern {period}")
    return tuple(kinds)


def n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // len(layer_pattern(cfg))


# --------------------------------------------------------------------------
# Templates
# --------------------------------------------------------------------------


def _attn_template(cfg: ModelConfig) -> dict:
    qdim = cfg.n_heads * cfg.d_head
    kvdim = cfg.n_kv_heads * cfg.d_head
    t = {
        "wq": dense(cfg.d_model, qdim, logical=(FSDP, TP)),
        "wk": dense(cfg.d_model, kvdim, logical=(FSDP, TP)),
        "wv": dense(cfg.d_model, kvdim, logical=(FSDP, TP)),
        "wo": dense(qdim, cfg.d_model, logical=(TP, FSDP)),
    }
    if cfg.qkv_bias:
        t["bq"] = dense(qdim, logical=(TP,), init="zeros")
        t["bk"] = dense(kvdim, logical=(TP,), init="zeros")
        t["bv"] = dense(kvdim, logical=(TP,), init="zeros")
    return t


def _block_template(cfg: ModelConfig, kind: BlockKind) -> dict:
    t: dict = {"norm1": dense(cfg.d_model, init="ones")}
    if kind.mixer == "attn":
        t["attn"] = _attn_template(cfg)
    else:
        t["ssm"] = ssm_template(cfg.ssm)
    has_ff = kind.moe or cfg.d_ff > 0
    if has_ff:
        t["norm2"] = dense(cfg.d_model, init="ones")
        if kind.moe:
            t["moe"] = moe_template(cfg.moe)
        else:
            t["mlp"] = mlp_template(MLPConfig(cfg.d_model, cfg.d_ff, cfg.act))
    if cfg.sandwich_norm:
        t["post_norm1"] = dense(cfg.d_model, init="ones")
        if has_ff:
            t["post_norm2"] = dense(cfg.d_model, init="ones")
    return t


def _stack(template, n: int):
    """Prepend the repeat-group axis (unsharded) to every leaf spec."""
    return tree_map(
        lambda _, s: dataclasses.replace(
            s, shape=(n, *s.shape), logical=(None, *(s.logical or (None,) * len(s.shape)))
        ),
        template,
    )


def model_template(cfg: ModelConfig) -> dict:
    pattern = layer_pattern(cfg)
    ng = n_groups(cfg)
    d_axis = FSDP if cfg.shard_head_dim else None
    t: dict = {
        "embed": dense(cfg.vocab, cfg.d_model, logical=(TP, d_axis), scale=0.02),
        "final_norm": dense(cfg.d_model, init="ones"),
        "blocks": {f"pos{i}": _stack(_block_template(cfg, k), ng) for i, k in enumerate(pattern)},
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = dense(cfg.d_model, cfg.vocab, logical=(d_axis, TP), scale=0.02)
    return t


# --------------------------------------------------------------------------
# Block application
# --------------------------------------------------------------------------


def _qkv(cfg, p, x):
    """The Q / K / V projections [B, S, heads * d_head] (column blocks of
    ``wq`` / ``wk`` / ``wv`` and their biases give the matching blocks)."""
    q = qdot(x, p["wq"])
    k = qdot(x, p["wk"])
    v = qdot(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return q, k, v


def _rotary_heads(cfg, q, k, v, positions, pos3, mode):
    """q / k / v [B, S, heads * d_head] -> per-head [B, S, heads, d_head],
    rotated (k / v repeated to every query head under ``gqa_flat`` outside
    decode)."""
    B, S, _ = q.shape
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.gqa_flat and cfg.n_kv_heads < cfg.n_heads and mode != "decode":
        rep = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    rot = int(cfg.d_head * cfg.rope_frac)

    def apply_rope(t):
        if rot == t.shape[-1]:
            if cfg.mrope:
                return attn_lib.mrope(t, pos3, cfg.rope_theta, cfg.mrope_sections)
            return attn_lib.rope(t, positions, cfg.rope_theta)
        t_rot = attn_lib.rope(t[..., :rot], positions, cfg.rope_theta)
        return torch.cat([t_rot, t[..., rot:]], dim=-1)

    return apply_rope(q), apply_rope(k), v


def _cache_entry(cfg, k, v, dtype):
    """A new token's K / V as the decode cache stores them (``dtype``), and
    the inverse scale that dequantizes them (None unless the cache is int8)."""
    if cfg.kv_cache_bits != 8:
        return k.to(dtype), v.to(dtype), None
    k = torch.clamp(torch.round(k.float() * cfg.kv_scale), -127, 127)
    v = torch.clamp(torch.round(v.float() * cfg.kv_scale), -127, 127)
    return k.to(dtype), v.to(dtype), 1.0 / cfg.kv_scale


def _attend(cfg, kind, q, k, v, positions, pos3, mode, cache):
    """Rotary, attention and the cache over ``cfg``'s head counts:
    q / k / v [B, S, heads * d_head] -> (out [B, S, n_heads * d_head], new_cache)."""
    B, S, _ = q.shape
    q, k, v = _rotary_heads(cfg, q, k, v, positions, pos3, mode)

    new_cache = None
    if mode == "decode":
        k, v, kv_inv_scale = _cache_entry(cfg, k, v, cache["k"].dtype)
        cache = KVCache.append_one(cache, k, v)
        out = attn_lib.decode_attend(
            q, cache, softcap=cfg.attn_softcap, window=kind.window, kv_inv_scale=kv_inv_scale
        )
        new_cache = cache
    else:
        if S < 4096:
            attend_fn = attn_lib.attend
        elif mode == "train":  # JAX trains through the plain code; the kernel has no backward
            attend_fn = attn_lib.attend_query_chunked
        else:
            attend_fn = attn_lib.attend_chunked
        out = attend_fn(
            q, k, v, mask=AttnMask(causal=True, window=kind.window), q_positions=positions,
            k_positions=positions, softcap=cfg.attn_softcap,
        )
        if mode == "prefill":
            new_cache = {
                "k": k.to(cfg.compute_dtype),
                "v": v.to(cfg.compute_dtype),
                "len": torch.full((B,), S, dtype=torch.int32, device=q.device),
            }
    return out.reshape(B, S, cfg.n_heads * cfg.d_head), new_cache


def _attn_apply(cfg, kind, p, x, positions, pos3, mode, cache):
    out, new_cache = _attend(cfg, kind, *_qkv(cfg, p, x), positions, pos3, mode, cache)
    return qdot(out, p["wo"]), new_cache


def _block_apply(cfg, kind, p, x, positions, pos3, mode, cache):
    """Pre-norm block. Returns (x, new_cache, aux_loss)."""
    h = rms_norm(x, p["norm1"])
    if kind.mixer == "attn":
        mix, new_cache = _attn_apply(cfg, kind, p["attn"], h, positions, pos3, mode, cache)
    elif mode == "decode":
        mix, new = ssm_decode_step(cfg.ssm, p["ssm"], cache, h)
        for name, t in new.items():  # in place, as the KV caches are written
            cache[name].copy_(t)
        new_cache = cache
    else:
        mix, state, conv_state = ssm_apply(cfg.ssm, p["ssm"], h)
        new_cache = None
        if mode == "prefill":
            new_cache = {"conv": conv_state.to(torch.float32), "state": state}
    if cfg.sandwich_norm:
        mix = rms_norm(mix, p["post_norm1"])
    x = x + mix

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind.moe or cfg.d_ff > 0:
        h = rms_norm(x, p["norm2"])
        if kind.moe:
            ff, aux = moe_apply(cfg.moe, p["moe"], h)
        else:
            ff = mlp_apply(MLPConfig(cfg.d_model, cfg.d_ff, cfg.act), p["mlp"], h)
        if cfg.sandwich_norm:
            ff = rms_norm(ff, p["post_norm2"])
        x = x + ff
    return x, new_cache, aux


# --------------------------------------------------------------------------
# Full passes
# --------------------------------------------------------------------------


def _embed_tokens(cfg, params, tokens, vision_embeds=None):
    # index first, then cast: the same values as casting the whole table first
    h = params["embed"][tokens].to(cfg.compute_dtype)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model**0.5, dtype=cfg.compute_dtype, device=h.device)
    if vision_embeds is not None:
        # VLM: precomputed patch embeddings (frontend stub) are prepended
        h = torch.cat([vision_embeds.to(cfg.compute_dtype), h], dim=1)
    return h


def _default_pos3(cfg, h, pos3):
    """M-RoPE positions: ``pos3`` as given, else every component the arange."""
    if not cfg.mrope or pos3 is not None:
        return pos3
    B, S = h.shape[:2]
    return torch.arange(S, device=h.device)[None, None, :].expand(3, B, S)


def _head_logits(cfg, h, head):
    """f32 logits of the (normed) ``h`` against ``head`` [D, V], softcapped;
    a column block of ``head`` gives its block of the vocab."""
    logits = torch.matmul(h.to(torch.float32), head.to(torch.float32))
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(cfg, params, h):
    return _head_logits(cfg, rms_norm(h, params["final_norm"]), _head(cfg, params))


def _scan_blocks(cfg, params, h, positions, pos3, mode, caches):
    """Loop over repeat groups; within a group, pattern positions unroll.

    Returns ``(h, caches, aux)``: decode updates ``caches`` in place and
    returns them; prefill returns the new exact-length caches, stacked over
    groups; train returns None.  ``aux`` sums the MoE blocks' auxiliary
    losses.  In train mode with ``remat="block"`` each group's body is
    recomputed in the backward pass instead of keeping its activations.
    """
    pattern = layer_pattern(cfg)
    ng = n_groups(cfg)
    new = {f"pos{i}": [] for i in range(len(pattern))}
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    all_params = unstack(params["blocks"], ng)
    all_caches = [None] * ng if caches is None else unstack(caches, ng)
    for g in range(ng):
        block_params, group_caches = all_params[g], all_caches[g]

        def group_body(h, block_params=block_params, group_caches=group_caches):
            aux_g = torch.zeros((), dtype=torch.float32, device=h.device)
            for i, kind in enumerate(pattern):
                cache_i = None if group_caches is None else group_caches[f"pos{i}"]
                h, new_cache, aux = _block_apply(
                    cfg, kind, block_params[f"pos{i}"], h, positions, pos3, mode, cache_i
                )
                aux_g = aux_g + aux
                new[f"pos{i}"].append(new_cache)
            return h, aux_g

        if mode == "train" and cfg.remat == "block" and torch.is_grad_enabled():
            h, aux_g = checkpoint(group_body, h, use_reentrant=False)
        else:
            h, aux_g = group_body(h)
        aux_total = aux_total + aux_g
    if mode == "decode":
        return h, caches, aux_total
    if mode == "train":
        return h, None, aux_total
    stacked = {
        pos: {name: torch.stack([c[name] for c in per_group]) for name in per_group[0]}
        for pos, per_group in new.items()
    }
    return h, stacked, aux_total


def forward(
    cfg: ModelConfig, params, tokens: torch.Tensor, *, positions=None, pos3=None, vision_embeds=None
):
    """Training forward: tokens [B, S] -> (logits [B, S(+vis), V] f32, aux_loss)."""
    h = _embed_tokens(cfg, params, tokens, vision_embeds)
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    pos3 = _default_pos3(cfg, h, pos3)
    h, _, aux = _scan_blocks(cfg, params, h, positions, pos3, "train", None)
    return _logits(cfg, params, h), aux


def _chunked_ce(cfg: ModelConfig, params, h: torch.Tensor, targets: torch.Tensor, chunk: int = 512):
    """Sequence-chunked cross-entropy: the f32 head matmul and log-softmax run
    per chunk of ``chunk`` positions, so the live logits stay [B, chunk, V]
    (JAX's scan over chunks)."""
    head = _head(cfg, params)
    B, S, _ = h.shape
    chunk = _ce_chunk(S, chunk)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        logits = _head_logits(cfg, h[:, i : i + chunk], head)
        logp = torch.log_softmax(logits, dim=-1)
        tc = targets[:, i : i + chunk].to(torch.int64)
        ll = torch.gather(logp, -1, tc[..., None])[..., 0]
        total = total - torch.sum(ll)
    return total / (B * S)


def _ce_chunk(S: int, chunk: int) -> int:
    return chunk if S % chunk == 0 else S  # one shot for odd smoke shapes


def lm_loss(cfg: ModelConfig, params, batch: dict):
    """Next-token cross-entropy (+ MoE aux). batch: tokens / targets [B, S],
    and for the VLM optionally ``vision_embeds`` and ``positions3``.

    Returns ``(ce + aux, {"ce": ce, "aux": aux})``.  Parameters placed on a
    mesh (``distributed/spmd.py``) run sharded (``models/sharded.py``).
    """
    if is_sharded(params["embed"]):
        from repro_torch.models import sharded

        return sharded.lm_loss(cfg, params, batch)
    h = _embed_tokens(cfg, params, batch["tokens"], batch.get("vision_embeds"))
    positions = torch.arange(h.shape[1], device=h.device)
    pos3 = _default_pos3(cfg, h, batch.get("positions3"))
    h, _, aux = _scan_blocks(cfg, params, h, positions, pos3, "train", None)
    h = rms_norm(h, params["final_norm"])
    targets = batch["targets"]
    h = h[:, -targets.shape[1] :, :]  # VLM: the loss over the text tail
    ce = _chunked_ce(cfg, params, h, targets)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, *, pos3=None, vision_embeds=None):
    """Full-context forward that also returns per-layer caches.

    tokens [B, S] (after ``vision_embeds`` [B, n_vis, D] where given) ->
    (logits [B, 1, V] of the last position, caches: exact-length K/V
    [groups, B, S, Hk, D]; SSM ``conv`` [groups, B, d_conv-1, conv_dim] and
    ``state`` [groups, B, H, P, N], f32).  Parameters placed on a mesh run
    sharded: the logits come back whole, the caches by ``cache_pspecs``.
    """
    if is_sharded(params["embed"]):
        from repro_torch.models import sharded

        return sharded.prefill(cfg, params, tokens, pos3=pos3, vision_embeds=vision_embeds)
    h = _embed_tokens(cfg, params, tokens, vision_embeds)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    pos3 = _default_pos3(cfg, h, pos3)
    h, caches, _ = _scan_blocks(cfg, params, h, positions, pos3, "prefill", None)
    return _logits(cfg, params, h[:, -1:, :]), caches


def decode_step(cfg: ModelConfig, params, caches, tokens: torch.Tensor, cur_len: torch.Tensor):
    """One-token decode. tokens [B, 1]; cur_len [B] current context length.

    Appends each slot's K/V and advances each SSM block's conv / state in
    ``caches`` in place; returns (logits [B, 1, V], caches).  Parameters
    placed on a mesh run sharded against caches sharded by ``cache_pspecs``.
    """
    if is_sharded(params["embed"]):
        from repro_torch.models import sharded

        return sharded.decode_step(cfg, params, caches, tokens, cur_len)
    h = _embed_tokens(cfg, params, tokens)
    positions = cur_len[:, None]  # [B, 1]
    pos3 = positions[None].expand(3, *positions.shape) if cfg.mrope else None
    h, caches, _ = _scan_blocks(cfg, params, h, positions, pos3, "decode", caches)
    return _logits(cfg, params, h), caches


def cache_template(cfg: ModelConfig, batch: int, max_len: int):
    """{pos: {name: (shape, dtype)}} of the stacked decode caches: K/V and
    length for attention blocks, f32 conv / state for SSM blocks."""
    ng = n_groups(cfg)
    kv_dtype = torch.int8 if cfg.kv_cache_bits == 8 else cfg.compute_dtype

    def one(kind):
        if kind.mixer == "attn":
            return KVCache.template(batch, max_len, cfg.n_kv_heads, cfg.d_head, kv_dtype)
        return ssm_cache_template(cfg.ssm, batch)

    return {
        f"pos{i}": {name: ((ng, *shape), dt) for name, (shape, dt) in one(kind).items()}
        for i, kind in enumerate(layer_pattern(cfg))
    }


def cache_specs(cfg: ModelConfig, batch_axes, tp_axis, seq_axis=None):
    """Partition specs matching :func:`cache_template`: K/V sharded [batch,
    seq?, kv-heads], SSM conv / state over batch and channels / heads."""
    out = {}
    for i, kind in enumerate(layer_pattern(cfg)):
        if kind.mixer == "attn":
            out[f"pos{i}"] = {
                "k": P(None, batch_axes, seq_axis, tp_axis, None),
                "v": P(None, batch_axes, seq_axis, tp_axis, None),
                "len": P(None, batch_axes),
            }
        else:
            out[f"pos{i}"] = {
                "conv": P(None, batch_axes, None, tp_axis),
                "state": P(None, batch_axes, tp_axis, None, None),
            }
    return out


def cache_init(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Zeroed decode caches on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return {
        pos: {name: torch.zeros(shape, dtype=dt, device=device) for name, (shape, dt) in c.items()}
        for pos, c in cache_template(cfg, batch, max_len).items()
    }
