"""Feed-forward blocks: SwiGLU / squared-ReLU / GELU MLPs.

Port of the dense half of ``repro/models/mlp.py``.  The mixture-of-experts
half (``MoEConfig`` is kept so configs carry the same fields) is not ported
yet: :func:`moe_apply` raises.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.precision import qdot
from repro_torch.models.common import dense

__all__ = ["MLPConfig", "MoEConfig", "mlp_template", "mlp_apply", "moe_apply"]

_MOE_TODO = "mixture-of-experts blocks are not ported yet (ROADMAP Queue 1 #12)"


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
    n_shared: int = 0
    capacity_factor: float = 1.25
    seq_chunk: int = 512
    router_aux_weight: float = 0.01
    shard_experts: str = "tp"


def mlp_template(cfg: MLPConfig) -> dict:
    t = {}
    if cfg.act == "swiglu":
        t["w_gate"] = dense(cfg.d_model, cfg.d_ff)
    t["w_up"] = dense(cfg.d_model, cfg.d_ff)
    t["w_down"] = dense(cfg.d_ff, cfg.d_model)
    return t


def mlp_apply(cfg: MLPConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = F.silu(qdot(x, params["w_gate"])) * qdot(x, params["w_up"])
    elif cfg.act == "sqrelu":
        h = torch.square(F.relu(qdot(x, params["w_up"])))
    elif cfg.act == "gelu":
        h = F.gelu(qdot(x, params["w_up"]), approximate="tanh")
    else:
        raise ValueError(cfg.act)
    return qdot(h, params["w_down"])


def moe_apply(cfg: MoEConfig, params, x):
    raise NotImplementedError(_MOE_TODO)
