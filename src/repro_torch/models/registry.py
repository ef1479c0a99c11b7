"""Architecture registry: one uniform handle per ported architecture.

Port of ``repro/models/registry.py``.  An :class:`Arch` bundles a model
config with its reduced variant, its parameter and input templates, real
init, its loss / prefill / decode functions and its cache template.
Templates are torch terms: ``{name: (shape, dtype)}`` with torch dtypes,
as :func:`~repro_torch.models.transformer.cache_template` gives them.
Configs register themselves on import from ``repro_torch.configs``: the
dense, MoE, SSM, hybrid and VLM configs of the decoder LM, and
whisper-medium (``family="audio"``, a :class:`~.whisper.WhisperConfig`,
whose handles go to ``models/whisper.py``).  The sharding entry points
(``param_pspecs``, ``param_shardings``, ``input_pspecs``, ``cache_pspecs``)
are JAX's rule tables over the port's :class:`~repro_torch.distributed.
sharding.Mesh` (any object with ``axis_names`` and a ``shape`` mapping
will do), with JAX's fallbacks to replication.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import P
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whs
from repro_torch.models.whisper import WhisperConfig

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

_PORTED_CONFIGS = (
    "phi3_medium_14b",
    "nemotron_4_15b",
    "stablelm_1_6b",
    "gemma2_27b",
    "granite_moe_1b",
    "qwen2_moe_a2_7b",
    "mamba2_780m",
    "jamba_v01_52b",
    "qwen2_vl_2b",
    "whisper_medium",
)

_REGISTRY: dict[str, "Arch"] = {}


def _batch_axes(mesh, global_batch: int | None = None) -> Any:
    """Batch sharding axes; falls back to replication when batch is too small
    to divide them (e.g. long_500k's global_batch=1)."""
    names = mesh.axis_names
    axes = tuple(n for n in ("pod", "data") if n in names)
    if not axes:
        return None
    if global_batch is not None:
        size = math.prod(mesh.shape[a] for a in axes)
        if global_batch % size:
            # try the smaller prefix ("pod" alone), else replicate
            for sub in (axes[:1], None):
                if sub is None:
                    return None
                sub_size = math.prod(mesh.shape[a] for a in sub)
                if global_batch % sub_size == 0 and global_batch >= sub_size:
                    return sub
    return axes


@dataclasses.dataclass
class Arch:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    config: Any  # ModelConfig | WhisperConfig
    reduced_config: Any
    skip_shapes: tuple[str, ...] = ()
    skip_reason: str = ""
    n_vision_tokens: int = 0

    # -- parameters ------------------------------------------------------
    def template(self, cfg=None):
        cfg = cfg or self.config
        if isinstance(cfg, WhisperConfig):
            return whs.whisper_template(cfg)
        return tfm.model_template(cfg)

    def abstract_params(self, cfg=None):
        """``{name: (shape, dtype)}`` of every parameter leaf (nested as the tree)."""
        return common.abstract(self.template(cfg))

    def init_params(self, gen: torch.Generator, cfg=None, device=None):
        """Random parameters from ``gen`` (on its device unless ``device`` is given)."""
        return common.materialize(gen, self.template(cfg), device)

    def param_shardings(self, mesh, cfg=None):
        return common.shardings(mesh, self.template(cfg))

    def param_pspecs(self, mesh, cfg=None):
        return common.partition_specs(mesh, self.template(cfg))

    # -- step functions ----------------------------------------------------
    def loss_fn(self, cfg=None) -> Callable:
        cfg = cfg or self.config
        if isinstance(cfg, WhisperConfig):
            return lambda params, batch: whs.whisper_loss(cfg, params, batch)
        return lambda params, batch: tfm.lm_loss(cfg, params, batch)

    def prefill_fn(self, cfg=None) -> Callable:
        cfg = cfg or self.config
        if isinstance(cfg, WhisperConfig):
            return lambda params, batch: whs.whisper_prefill(cfg, params, batch["audio_frames"])
        return lambda params, batch: tfm.prefill(
            cfg,
            params,
            batch["tokens"],
            vision_embeds=batch.get("vision_embeds"),
            pos3=batch.get("positions3"),
        )

    def decode_fn(self, cfg=None) -> Callable:
        cfg = cfg or self.config
        if isinstance(cfg, WhisperConfig):
            return lambda params, caches, batch: whs.whisper_decode_step(
                cfg, params, caches, batch["tokens"], batch["cur_len"]
            )
        return lambda params, caches, batch: tfm.decode_step(
            cfg, params, caches, batch["tokens"], batch["cur_len"]
        )

    # -- inputs ------------------------------------------------------------
    def input_template(self, shape: ShapeSpec, cfg=None) -> dict:
        """``{name: (shape, dtype)}`` of every model input of this (arch x shape) cell.

        Modality frontends are stubs.  The VLM gets precomputed bf16 patch
        embeddings (``n_vision_tokens``, at most half the sequence) before
        the text tokens, and int32 M-RoPE positions [3, B, S].  Whisper gets
        precomputed bf16 mel-frame embeddings [B, S, d_model] (train and
        prefill) and decoder tokens of min(``dec_max_len``, S) (train)."""
        cfg = cfg or self.config
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if isinstance(cfg, WhisperConfig) and shape.kind in ("train", "prefill"):
            t = {"audio_frames": ((B, S, cfg.d_model), torch.bfloat16)}
            if shape.kind == "train":
                dec = min(cfg.dec_max_len, S)
                t.update(tokens=((B, dec), i32), targets=((B, dec), i32))
            return t
        if shape.kind not in ("train", "prefill"):
            return {"tokens": ((B, 1), i32), "cur_len": ((B,), i32)}
        n_vis = min(self.n_vision_tokens, S // 2) if self.family == "vlm" else 0
        t = {"tokens": ((B, S - n_vis), i32)}
        if shape.kind == "train":
            t["targets"] = ((B, S - n_vis), i32)
        if n_vis:
            t["vision_embeds"] = ((B, n_vis, cfg.d_model), torch.bfloat16)
            t["positions3"] = ((3, B, S), i32)
        return t

    def input_pspecs(self, mesh, shape: ShapeSpec, cfg=None) -> dict:
        b = _batch_axes(mesh, shape.global_batch)
        specs = {}
        for k, (s, _) in self.input_template(shape, cfg).items():
            if k == "positions3":
                specs[k] = P(None, b, None)
            else:
                specs[k] = P(b, *(None,) * (len(s) - 1))
        return specs

    def input_concrete(self, gen: torch.Generator, shape: ShapeSpec, cfg=None, device=None) -> dict:
        """Random realised inputs from ``gen`` (on its device unless ``device``
        is given): int inputs uniform over the vocab (``positions3`` too, as
        in JAX), ``cur_len`` half the sequence, float inputs standard normal
        drawn in f32 and cast."""
        cfg = cfg or self.config
        device = torch.device(device) if device is not None else gen.device
        out = {}
        for k, (s, dt) in self.input_template(shape, cfg).items():
            if k == "cur_len":
                out[k] = torch.full(s, shape.seq_len // 2, dtype=dt, device=device)
            elif dt.is_floating_point:
                x = torch.randn(s, generator=gen, dtype=torch.float32, device=gen.device)
                out[k] = x.to(device=device, dtype=dt)
            else:
                x = torch.randint(0, cfg.vocab, s, generator=gen, dtype=dt, device=gen.device)
                out[k] = x.to(device)
        return out

    # -- caches --------------------------------------------------------
    def cache_abstract(self, shape: ShapeSpec, cfg=None):
        cfg = cfg or self.config
        if isinstance(cfg, WhisperConfig):
            return whs.whisper_cache_template(cfg, shape.global_batch, shape.seq_len)
        return tfm.cache_template(cfg, shape.global_batch, shape.seq_len)

    def cache_pspecs(self, mesh, shape: ShapeSpec, cfg=None, shard_seq: bool = False):
        """The decode caches' specs: batch over ``input_pspecs``' axes, kv
        heads over ``model`` where they divide; ``shard_seq`` puts the
        sequence of the KV caches (Whisper's cross cache) over ``data``.
        Where the batch already splits over ``data`` that names the axis
        twice: placing by such a spec (a
        :class:`~repro_torch.distributed.sharding.NamedSharding`) raises
        ``DuplicateSpecError``, as JAX's does."""
        cfg = cfg or self.config
        b = _batch_axes(mesh, shape.global_batch)
        tp = "model" if "model" in mesh.axis_names else None
        seq = "data" if shard_seq and "data" in mesh.axis_names else None
        if tp is not None:
            # explicit placements must divide exactly
            n_kv = cfg.n_heads if isinstance(cfg, WhisperConfig) else cfg.n_kv_heads
            if n_kv % mesh.shape["model"]:
                tp = None
        if isinstance(cfg, WhisperConfig):
            return whs.whisper_cache_specs(b, tp, seq)
        return tfm.cache_specs(cfg, b, tp, seq)

    def runs_shape(self, shape_name: str) -> bool:
        return shape_name not in self.skip_shapes


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
