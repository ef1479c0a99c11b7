"""Architecture registry: one uniform handle per ported architecture.

Port of ``repro/models/registry.py``.  An :class:`Arch` bundles a model
config with its reduced variant, its parameter template and its prefill
step.
Configs register themselves on import from ``repro_torch.configs``; only
the families whose blocks are ported load (the four dense configs).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import torch

from repro_torch.models import common
from repro_torch.models import transformer as tfm

__all__ = ["ShapeSpec", "SHAPES", "Arch", "register", "get_arch", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

_PORTED_CONFIGS = ("phi3_medium_14b", "nemotron_4_15b", "stablelm_1_6b", "gemma2_27b")

_REGISTRY: dict[str, "Arch"] = {}


@dataclasses.dataclass
class Arch:
    name: str
    family: str
    config: Any  # ModelConfig
    reduced_config: Any
    skip_shapes: tuple[str, ...] = ()
    skip_reason: str = ""
    n_vision_tokens: int = 0

    def template(self, cfg=None):
        return tfm.model_template(cfg or self.config)

    def init_params(self, gen: torch.Generator, cfg=None, device=None):
        """Random parameters from ``gen`` (on its device unless ``device`` is given)."""
        return common.materialize(gen, self.template(cfg), device)

    def prefill_fn(self, cfg=None) -> Callable:
        cfg = cfg or self.config
        return lambda params, batch: tfm.prefill(cfg, params, batch["tokens"])


def register(arch: Arch) -> Arch:
    _REGISTRY[arch.name] = arch
    return arch


def _load_all() -> None:
    for mod in _PORTED_CONFIGS:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str) -> Arch:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)
