"""Feed-forward blocks: SwiGLU / squared-ReLU / GELU MLPs and capacity-based MoE.

Port of ``repro/models/mlp.py``.  The MoE is JAX's dispatch/combine einsum
formulation: chunked over the sequence so the one-hot dispatch tensor stays
bounded, top-k routing with a capacity per (batch row, chunk) and the
Switch-style load-balancing auxiliary loss.  The expert products are plain
einsums in JAX (no Pallas kernel), and so they are here.

Routing is equal to JAX's on every device: ``jax.lax.top_k`` breaks ties
toward the lower expert, and ``torch.topk`` promises no tie order on the
card, so the top k come from a stable descending sort.  The capacity
positions are an f32 ``cumsum``, as in JAX (exact below 2^24 tokens a
chunk).  ``shard_experts`` picks the experts' logical axes (``tp``,
``fsdp`` or ``megatron``, JAX's) and changes nothing on one device.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.precision import qdot
from repro_torch.models.common import FSDP, TP, dense

__all__ = [
    "MLPConfig", "MoEConfig", "mlp_template", "mlp_hidden", "mlp_apply", "moe_template", "moe_apply",
]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    act: str = "swiglu"  # swiglu | sqrelu | gelu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    n_shared: int = 0  # always-on experts (qwen2-moe)
    capacity_factor: float = 1.25
    seq_chunk: int = 512
    router_aux_weight: float = 0.01
    shard_experts: str = "tp"


def mlp_template(cfg: MLPConfig) -> dict:
    t = {}
    if cfg.act == "swiglu":
        t["w_gate"] = dense(cfg.d_model, cfg.d_ff, logical=(FSDP, TP))
    t["w_up"] = dense(cfg.d_model, cfg.d_ff, logical=(FSDP, TP))
    t["w_down"] = dense(cfg.d_ff, cfg.d_model, logical=(TP, FSDP))
    return t


def mlp_hidden(cfg: MLPConfig, params, x: torch.Tensor) -> torch.Tensor:
    """The activated hidden layer [..., d_ff]: elementwise over the columns
    of ``w_gate`` / ``w_up``, so a column block of them gives its block."""
    if cfg.act == "swiglu":
        return F.silu(qdot(x, params["w_gate"])) * qdot(x, params["w_up"])
    if cfg.act == "sqrelu":
        return torch.square(F.relu(qdot(x, params["w_up"])))
    if cfg.act == "gelu":
        return F.gelu(qdot(x, params["w_up"]), approximate="tanh")
    raise ValueError(cfg.act)


def mlp_apply(cfg: MLPConfig, params, x: torch.Tensor) -> torch.Tensor:
    return qdot(mlp_hidden(cfg, params, x), params["w_down"])


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------


def _shared_cfg(cfg: MoEConfig) -> MLPConfig:
    return MLPConfig(cfg.d_model, cfg.d_ff_expert * cfg.n_shared, "swiglu")


def moe_template(cfg: MoEConfig) -> dict:
    if cfg.shard_experts == "megatron":
        # experts replicated; each expert's FFN dim is TP-sharded
        gate_ax, down_ax = (None, None, TP), (None, TP, None)
    else:
        e_ax = TP if cfg.shard_experts == "tp" else FSDP
        ff_ax = FSDP if cfg.shard_experts == "tp" else TP
        gate_ax, down_ax = (e_ax, ff_ax, None), (e_ax, None, ff_ax)
    t = {
        "router": dense(cfg.d_model, cfg.n_experts, logical=(FSDP, None), scale=0.02),
        "w_gate": dense(cfg.n_experts, cfg.d_model, cfg.d_ff_expert, logical=gate_ax),
        "w_up": dense(cfg.n_experts, cfg.d_model, cfg.d_ff_expert, logical=gate_ax),
        "w_down": dense(cfg.n_experts, cfg.d_ff_expert, cfg.d_model, logical=down_ax),
    }
    if cfg.n_shared:
        t["shared"] = mlp_template(_shared_cfg(cfg))
    return t


def _capacity(cfg: MoEConfig, chunk: int) -> int:
    return max(1, math.ceil(chunk * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def _top_k(cfg: MoEConfig, router_logits: torch.Tensor):
    """Router probabilities [B,C,E] and the top-k experts [B,C,k].

    The top k of a stable descending sort: equal probabilities keep the
    lower expert first, as ``jax.lax.top_k`` does.
    """
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    return probs, idx[..., : cfg.top_k]


def _gates(cfg: MoEConfig, probs: torch.Tensor, top_idx: torch.Tensor):
    """The one-hot of the top k [B,C,k,E] and the gates [B,C,E]: the top k's
    probabilities renormalised, zeros elsewhere."""
    top_vals = torch.gather(probs, -1, top_idx)
    top_vals = top_vals / (torch.sum(top_vals, dim=-1, keepdim=True) + 1e-9)
    # JAX's einsum of the values with a one-hot over experts: each gate is one
    # value plus exact zeros, so a scatter gives the same bits
    gate_full = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
    onehot = F.one_hot(top_idx, cfg.n_experts).to(probs.dtype)  # [B,C,k,E]
    return onehot, gate_full


def _route(cfg: MoEConfig, router_logits: torch.Tensor):
    """Top-k routing. logits [B,C,E] -> (gates [B,C,E], aux_loss)."""
    probs, top_idx = _top_k(cfg, router_logits)
    onehot, gate_full = _gates(cfg, probs, top_idx)
    # Load-balance loss (Switch-style): mean prob * mean assignment per expert.
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))
    aux = cfg.n_experts * torch.sum(me * ce)
    return gate_full, aux


def _dispatch(cfg: MoEConfig, gates: torch.Tensor, dt: torch.dtype):
    """The dispatch and combine tensors [B,C,E,cap] of a chunk's gates: each
    token's slot in its expert's capacity buffer, a cumsum over the chunk
    (dim 1) of every batch row on its own; assignments past the capacity
    are dropped."""
    cap = _capacity(cfg, gates.shape[1])
    assign = (gates > 0).to(torch.float32)  # [B,C,E]
    pos = torch.cumsum(assign, dim=1) * assign - 1.0  # -1 = unassigned
    keep = (pos >= 0) & (pos < cap)
    pos = torch.clamp(pos, 0, cap - 1).to(torch.int64)
    # dispatch[b,c,e,cap]: one-hot over capacity slot
    disp = F.one_hot(pos, cap).to(dt) * keep[..., None].to(dt)
    return disp, disp * gates[..., None].to(dt)


def _experts(params, expert_in: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their buffers: expert_in [E,B,cap,D] ->
    expert_out [E,B,cap,D] (a block of experts, of D or of F gives its block)."""
    dt = expert_in.dtype
    h = F.silu(torch.einsum("ebkd,edf->ebkf", expert_in, params["w_gate"].to(dt))) * torch.einsum(
        "ebkd,edf->ebkf", expert_in, params["w_up"].to(dt)
    )
    return torch.einsum("ebkf,efd->ebkd", h, params["w_down"].to(dt))


def _moe_chunk(cfg: MoEConfig, params, x_chunk: torch.Tensor):
    """x_chunk [B, C, D] -> (out [B, C, D], aux)."""
    logits = torch.einsum(
        "bcd,de->bce", x_chunk.to(torch.float32), params["router"].to(torch.float32)
    )
    gates, aux = _route(cfg, logits)  # [B,C,E]
    disp, combine = _dispatch(cfg, gates, x_chunk.dtype)
    expert_in = torch.einsum("bcek,bcd->ebkd", disp, x_chunk)  # [E,B,cap,D]
    out = torch.einsum("bcek,ebkd->bcd", combine, _experts(params, expert_in))
    return out, aux


def _chunks(cfg: MoEConfig, x: torch.Tensor) -> list[torch.Tensor]:
    """The sequence chunks of x [B, S, D]; a ragged last chunk is zero-padded
    (its padding routes but is discarded)."""
    S = x.shape[1]
    chunk = min(cfg.seq_chunk, S)
    pad = -S % chunk
    x_p = F.pad(x, (0, 0, 0, pad)) if pad else x
    return list(x_p.split(chunk, dim=1))


def moe_apply(cfg: MoEConfig, params, x: torch.Tensor):
    """x [B, S, D] -> (out [B, S, D], aux_loss scalar)."""
    S = x.shape[1]
    chunks = _chunks(cfg, x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = []
    for xc in chunks:
        out, aux = _moe_chunk(cfg, params, xc)
        aux_total = aux_total + aux
        outs.append(out)
    out = torch.cat(outs, dim=1)[:, :S]
    if cfg.n_shared:
        out = out + mlp_apply(_shared_cfg(cfg), params["shared"], x)
    return out, cfg.router_aux_weight * aux_total / max(1, len(chunks))
