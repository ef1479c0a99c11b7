"""Optimizers as plain functions over lists of tensors (port of
``repro/train/optimizer.py``).

AdamW and SGD-momentum with the functional (init, update) interface,
global-norm gradient clipping, schedules and :func:`apply_updates`.  The
arithmetic is the JAX version's, in its order and in float32 -- AdamW's
``u = mhat / (sqrt(vhat) + eps) + wd * p`` with bias corrections
``1 - b ** f32(step)`` -- so one update agrees with the JAX package's to
float32 rounding.  ``torch.optim.AdamW`` applies the decay separately and in
another order, so it is not used.

Optimizer state lives on the parameters' device: the step counter is an
int32 tensor there and the schedules compute the learning rate there, so an
update never waits on the host.  A leading candidate axis on every tensor
(the stacked parameters of a population fine-tune) needs nothing special:
the update is elementwise, and :func:`clip_by_global_norm` takes
``batch_dims=1`` to clip each candidate by its own norm.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.common import params_from_numpy, tree_leaves, tree_unflatten

__all__ = [
    "Optimizer",
    "adamw",
    "sgd",
    "clip_by_global_norm",
    "cosine_schedule",
    "constant_schedule",
    "linear_warmup_cosine",
    "apply_updates",
    "adamw_state_from_numpy",
    "adamw_state_to_numpy",
]

f32 = torch.float32


class Optimizer(NamedTuple):
    """(init, update) pair; update(grads, state, params) -> (updates, state)."""

    init: Callable
    update: Callable


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the parameters' device
    mu: list  # first moments, one per parameter
    nu: list  # second moments, one per parameter


def _lr_fn(lr) -> Callable:
    return lr if callable(lr) else constant_schedule(lr)


def _step0(params: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def adamw(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    *,
    moment_dtype=f32,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype)
        return AdamWState(
            step=_step0(params), mu=[zeros(p) for p in params], nu=[zeros(p) for p in params]
        )

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        sf = step.to(f32)
        c1 = 1.0 - b1**sf
        c2 = 1.0 - b2**sf
        mu = [b1 * m + (1 - b1) * g.to(m.dtype) for m, g in zip(state.mu, grads)]
        nu = [b2 * v + (1 - b2) * torch.square(g.to(v.dtype)) for v, g in zip(state.nu, grads)]

        def upd(m, v, p):
            mhat = m / c1
            vhat = v / c2
            u = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(m.dtype)
            return (-lr_t * u).to(p.dtype)

        updates = [upd(m, v, p) for m, v, p in zip(mu, nu, params)]
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: list


def sgd(lr, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return SGDState(step=_step0(params), momentum=[torch.zeros_like(p) for p in params])

    def update(grads, state, params):
        step = state.step + 1
        buf = [momentum * b + g for b, g in zip(state.momentum, grads)]
        eff = [g + momentum * b for g, b in zip(grads, buf)] if nesterov else buf
        lr_t = lr_fn(step)
        updates = [(-lr_t * e).to(p.dtype) for e, p in zip(eff, params)]
        return updates, SGDState(step=step, momentum=buf)

    return Optimizer(init, update)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float, batch_dims: int = 0):
    """Scale ``grads`` so that their global L2 norm is at most ``max_norm``.

    Returns ``(clipped, gnorm)``.  With ``batch_dims=1`` every tensor carries
    a leading candidate axis [K, ...] and each candidate is clipped by the
    norm of its own slices: ``gnorm`` is then [K], as JAX's ``vmap`` of the
    unbatched function gives it.
    """
    if batch_dims not in (0, 1):
        raise ValueError(f"batch_dims must be 0 or 1, got {batch_dims}")

    def sq(g):
        g2 = torch.square(g.to(f32))
        return g2.sum() if batch_dims == 0 else g2.reshape(g.shape[0], -1).sum(dim=1)

    gnorm = torch.sqrt(sum(sq(g) for g in grads))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    if batch_dims == 0:
        return [g * scale for g in grads], gnorm
    return [g * scale.reshape((-1,) + (1,) * (g.dim() - 1)) for g in grads], gnorm


def constant_schedule(value: float):
    return lambda step: torch.full((), value, dtype=f32, device=step.device)


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = torch.clamp(step.to(f32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * (final_frac + (1.0 - final_frac) * cos)

    return fn


def linear_warmup_cosine(
    base_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
):
    cos = cosine_schedule(base_lr, max(1, total_steps - warmup_steps), final_frac)

    def fn(step):
        warm = base_lr * step.to(f32) / max(1, warmup_steps)
        return torch.where(step <= warmup_steps, warm, cos(step - warmup_steps))

    return fn


def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> list:
    return [p + u.to(p.dtype) for p, u in zip(params, updates)]


def adamw_state_from_numpy(state, device="cuda") -> AdamWState:
    """Carry a JAX ``AdamWState`` -- ``step`` and the moment trees ``mu`` and
    ``nu`` over a nested-dict parameter tree, with every leaf a numpy array
    (``jax.tree.map(np.asarray, state)``) -- onto ``device`` as the port's
    state: the moments as flat lists in ``tree_leaves`` order, the order the
    LM train step flattens the parameters in."""
    device = resolve_device(device)
    mu, nu = params_from_numpy(state.mu, device), params_from_numpy(state.nu, device)
    step = torch.tensor(int(state.step), dtype=torch.int32, device=device)
    return AdamWState(
        step=step, mu=[t for _, t in tree_leaves(mu)], nu=[t for _, t in tree_leaves(nu)]
    )


def adamw_state_to_numpy(state: AdamWState, like) -> dict:
    """The port's state back as numpy: ``{"step", "mu", "nu"}`` with the
    moments as nested dicts shaped as the parameter tree ``like`` (the
    fields of JAX's ``AdamWState``)."""
    host = lambda ts: [t.detach().cpu().numpy() for t in ts]
    return {
        "step": np.asarray(state.step.cpu().numpy(), np.int32),
        "mu": tree_unflatten(like, host(state.mu)),
        "nu": tree_unflatten(like, host(state.nu)),
    }
