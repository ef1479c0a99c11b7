"""Structural (analytical) HBM-traffic and capacity model per dry-run cell.

Port of ``repro/distributed/structural.py``, over the port's ``(shape,
dtype)`` templates.  For one (arch x shape) cell it gives the least traffic
a well-fused program must still pay -- parameter / optimizer-state streams,
remat-boundary activations, attention score tiles, KV-cache reads and
writes -- and the resident bytes per device, both as arithmetic on the
templates; ``model_flops`` gives 6 N D (train) / 2 N D (inference) with N
the parameters a token touches (MoE: top_k of n_experts routed).

The mesh factors are JAX's dry-run meshes, (256 devices, 16 batch shards,
16 model shards) and (512, 32, 16) with ``multi_pod``: they describe those
meshes (ROADMAP Queue 1 #6.5), not one card.  Nothing here runs on a device.
"""

from __future__ import annotations

import math

from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import Arch, ShapeSpec
from repro_torch.models.transformer import layer_pattern
from repro_torch.models.whisper import WhisperConfig

__all__ = [
    "param_bytes",
    "param_count",
    "structural_bytes",
    "model_flops",
    "capacity_bytes",
    "capacity_bytes_serve_optimized",
]


def _tree_bytes(tree) -> int:
    return sum(math.prod(shape) * dtype.itemsize for _, (shape, dtype) in tree_leaves(tree))


def _tree_count(tree) -> int:
    return sum(math.prod(shape) for _, (shape, _) in tree_leaves(tree))


def param_bytes(arch: Arch, cfg=None) -> int:
    return _tree_bytes(arch.abstract_params(cfg or arch.config))


def param_count(arch: Arch, cfg=None) -> int:
    return _tree_count(arch.abstract_params(cfg or arch.config))


def _active_param_count(arch: Arch, cfg) -> int:
    """Parameters touched per token (MoE: top_k of n_experts routed)."""
    total = param_count(arch, cfg)
    if isinstance(cfg, WhisperConfig) or cfg.moe is None:
        return total
    moe = cfg.moe
    expert_p = 3 * moe.d_model * moe.d_ff_expert  # gate/up/down per expert
    pattern = layer_pattern(cfg)
    n_moe_layers = sum(k.moe for k in pattern) * (cfg.n_layers // len(pattern))
    inactive = n_moe_layers * (moe.n_experts - moe.top_k) * expert_p
    return total - inactive


def model_flops(arch: Arch, shape: ShapeSpec, cfg=None) -> float:
    """6 * N_active * D for train; 2 * N_active * D for inference steps."""
    cfg = cfg or arch.config
    n_active = _active_param_count(arch, cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per sample


def _mesh_factors(multi_pod: bool) -> tuple[int, int, int]:
    """(n_devices, batch_shards, model_shards) of JAX's dry-run meshes."""
    return (512, 32, 16) if multi_pod else (256, 16, 16)


def structural_bytes(
    arch: Arch,
    shape: ShapeSpec,
    *,
    multi_pod: bool = False,
    quant_bits: int | None = None,
    serve_optimized: bool = False,
    cfg=None,
) -> dict:
    """Per-device HBM traffic (bytes) for one step of this cell.

    ``serve_optimized`` models the TP-only serving layout: weights live
    bf16 (or quantized) replicated over the data axis, so each device reads
    1/TP of the model per step (vs 1/n_dev under FSDP, which pays the
    all-gather on the wire instead).
    """
    cfg = cfg or arch.config
    n_dev, b_shards, m_shards = _mesh_factors(multi_pod)
    B = shape.global_batch
    S = shape.seq_len

    p_bytes_total = param_bytes(arch, cfg)
    if shape.kind != "train":
        if quant_bits:
            # int8-class storage (bits 5..8) = 1 byte/weight; packed int4 = 0.5
            p_bytes_total = param_count(arch, cfg) * (0.5 if quant_bits == 4 else 1.0)
        elif serve_optimized:
            p_bytes_total = param_count(arch, cfg) * 2.0  # bf16 serving copy
    p_dev = p_bytes_total / (m_shards if serve_optimized else n_dev)

    d_model = cfg.d_model
    if isinstance(cfg, WhisperConfig):
        n_layers = cfg.n_enc_layers + cfg.n_dec_layers
        pattern = None
    else:
        n_layers = cfg.n_layers
        pattern = layer_pattern(cfg)

    # attention score-tile traffic (per step, per device): each score element
    # is ~2 bytes (bf16) and crosses HBM `passes` times (forward reads and
    # writes, and the recompute and backward passes in training)
    def attn_traffic(tokens_loc: float, kv_len: int, passes: float) -> float:
        h_loc = max(1.0, cfg.n_heads / m_shards)
        if isinstance(cfg, WhisperConfig):
            # the encoder's self-attention (kv = encoder length); the
            # decoder's tokens are capped at dec_max_len, negligible beside it
            return passes * tokens_loc * kv_len * h_loc * 2.0 * cfg.n_enc_layers
        total = 0.0
        ng = cfg.n_layers // len(pattern)
        for k in pattern:
            if k.mixer != "attn":
                continue
            kv = min(kv_len, k.window) if k.window else kv_len
            total += passes * tokens_loc * kv * h_loc * 2.0 * ng
        return total

    act_pass = d_model * 2.0  # one bf16 tensor pass per token per layer

    if shape.kind == "train":
        tokens_loc = (B / b_shards) * S  # batch sharded; seq local
        traffic = {
            # fwd read + bwd read (remat) + grad w/r + adam p,m,v r/w (f32)
            "params_opt": 15.0 * 4.0 * param_count(arch, cfg) / n_dev,
            "activations": tokens_loc * act_pass * n_layers * 32.0,
            "attention": attn_traffic(tokens_loc, S, passes=12.0),
        }
    elif shape.kind == "prefill":
        tokens_loc = (B / b_shards) * S
        cache = _tree_bytes(arch.cache_abstract(shape, cfg)) / n_dev
        traffic = {
            "params": p_dev,
            "activations": tokens_loc * act_pass * n_layers * 8.0,
            "attention": attn_traffic(tokens_loc, S, passes=4.0),
            "cache_write": cache,
        }
    else:  # decode: one token per sample
        cache = _tree_bytes(arch.cache_abstract(shape, cfg)) / n_dev
        tokens_loc = max(1.0, B / b_shards)
        traffic = {
            "params": p_dev,  # every weight read once per decoded token
            "cache_read": cache,
            "activations": tokens_loc * act_pass * n_layers * 8.0,
        }
    traffic["total"] = float(sum(traffic.values()))
    return traffic


def capacity_bytes(
    arch: Arch, shape: ShapeSpec, *, multi_pod: bool = False, quant_bits: int | None = None, cfg=None
) -> dict:
    """Resident per-device HBM: params (+opt state), caches, live activations."""
    cfg = cfg or arch.config
    n_dev, b_shards, _ = _mesh_factors(multi_pod)
    p_count = param_count(arch, cfg)
    resident = {}
    if shape.kind == "train":
        resident["params_opt"] = 12.0 * p_count / n_dev  # f32 p + m + v
        resident["grads"] = 4.0 * p_count / n_dev
        tokens_loc = (shape.global_batch / b_shards) * shape.seq_len
        n_layers = (
            cfg.n_enc_layers + cfg.n_dec_layers if isinstance(cfg, WhisperConfig) else cfg.n_layers
        )
        resident["saved_activations"] = tokens_loc * cfg.d_model * 2.0 * n_layers  # remat: block inputs
        resident["workspace"] = 1.5e9
    else:
        p_bytes = param_bytes(arch, cfg) / n_dev
        if quant_bits:
            p_bytes = p_bytes * quant_bits / 32.0
        resident["params"] = p_bytes
        resident["cache"] = _tree_bytes(arch.cache_abstract(shape, cfg)) / n_dev
        resident["workspace"] = 1.0e9
    resident["total"] = float(sum(resident.values()))
    return resident


def capacity_bytes_serve_optimized(
    arch: Arch, shape: ShapeSpec, *, multi_pod: bool = False, quant_bits: int | None = None, cfg=None
) -> dict:
    """Resident bytes under the TP-only serving layout."""
    cfg = cfg or arch.config
    n_dev, _, m_shards = _mesh_factors(multi_pod)
    count = param_count(arch, cfg)
    per = 0.5 if quant_bits == 4 else (1.0 if quant_bits else 2.0)
    resident = {
        "params": count * per / m_shards,
        "cache": _tree_bytes(arch.cache_abstract(shape, cfg)) / n_dev,
        "workspace": 1.0e9,
    }
    resident["total"] = float(sum(resident.values()))
    return resident
