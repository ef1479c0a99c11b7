"""The Mamba-2 mixer over a named mesh: its heads over ``model``.

JAX's specs split ``in_proj``'s columns ``[z | x | B | C | dt]`` and
``conv_w`` / ``conv_b``'s ``[x | B | C]`` contiguously over ``model``,
which does not follow the heads, and constrain the SSD's x to heads over
``model``; XLA reshards between the two.  Here:

* the column-parallel ``in_proj`` output is all-gathered over ``model``
  (its gradient lands back in JAX's layout of ``in_proj``) and ``conv_w``
  / ``conv_b`` are gathered whole (4 x conv_dim: small);
* where the heads divide over ``model`` (``a_log`` is split), each shard
  takes its heads' z, x and dt and the whole B and C (one group), runs the
  depthwise conv on those channels and the SSD on its heads; the gated
  ``rms_norm`` over d_inner all-reduces its f32 sums of squares over
  ``model``, and ``out_proj`` is row-parallel (f32 partials from
  ``quant_matmul`` when quantized).  Otherwise every shard runs every
  head, as on one device;
* caches follow ``cache_pspecs``: ``state`` [B, H, P, N] with its heads
  over ``model`` where the kv heads divide (then the heads are local
  too), and ``conv`` [B, K-1, conv_dim] split contiguously there.  Prefill
  writes each shard its spec's block of the conv state; decode all-gathers
  the conv cache over ``model`` before the conv, then writes every shard's
  block back in place.  Heads that are local while the state is
  replicated (mamba2: one kv head) are gathered before the write.

The SSD keeps its f32 passes and its Python inter-chunk loop on each
shard's heads (``models/mamba2.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.precision import qdot
from repro_torch.distributed.spmd import all_gather, local
from repro_torch.models.common import rms_norm
from repro_torch.models.mamba2 import _causal_conv, _decays, _split_in_proj, ssd_scan, ssd_step
from repro_torch.models.sharded import _model_dim

__all__ = ["ssm_mixer"]


def _gated_norm(run, gs: list, norm_w, split: bool, eps: float = 1e-6) -> list:
    """``rms_norm(y * silu(z), norm_w)`` over d_inner; with the heads (and
    ``norm_w``) split over ``model``, the mean of squares sums f32 partials
    across the shards."""
    if not split:
        return [rms_norm(g, w, eps) for g, w in zip(gs, run.whole(norm_w))]
    d_inner = run.cfg.ssm.d_inner
    gf = [g.to(torch.float32) for g in gs]
    ss = run.psum([torch.sum(torch.square(t), dim=-1, keepdim=True) for t in gf])
    return [
        (t * torch.rsqrt(s / d_inner + eps) * local(norm_w, i).to(torch.float32)).to(g.dtype)
        for i, (t, s, g) in enumerate(zip(gf, ss, gs))
    ]


def _block(t: torch.Tensor, i: int, run) -> torch.Tensor:
    """Shard ``i``'s contiguous block of the last dim over ``model``."""
    k = t.shape[-1] // run.tp
    return t.narrow(-1, run.m[i] * k, k)


def ssm_mixer(run, p, hs: list, mode: str, caches: list | None):
    """``mamba2.ssm_apply`` (train / prefill) or ``ssm_decode_step`` (decode)
    on every shard: hs [B_l, L, D] -> (out per shard, per-shard caches:
    prefill's new blocks, decode's written in place)."""
    cfg = run.cfg.ssm
    tp, decode = run.tp, mode == "decode"
    if cfg.n_groups != 1 and tp > 1:
        raise NotImplementedError("the SSM over 'model' holds B and C whole: one group only")
    zx = [qdot(h, local(p["in_proj"], i)) for i, h in enumerate(hs)]
    if tp > 1 and _model_dim(p["in_proj"]) is not None:
        zx = run.gather(zx)
    conv_w, conv_b = run.whole(p["conv_w"]), run.whole(p["conv_b"])
    heads_local = tp > 1 and _model_dim(p["a_log"]) is not None
    H, Pd, d_in, K = cfg.n_heads, cfg.head_dim, cfg.d_inner, cfg.d_conv
    Hl = H // tp if heads_local else H
    per_head = [
        [local(p[k], i) for i in range(run.n)] if heads_local else run.whole(p[k])
        for k in ("a_log", "dt_bias", "d_skip")
    ]
    cache_split = tp > 1 and run.kv_axis == "model"  # conv / state blocks over model
    if cache_split and not heads_local:
        raise ValueError("the SSM caches split over 'model' but its heads do not")
    conv_old = None
    if decode:
        conv_old = [c["conv"] for c in caches]
        if cache_split:
            conv_old = run.gather(conv_old)
    gs, tails, states = [], [], []
    for i, h in enumerate(hs):
        B_, L = h.shape[:2]
        z, xbc, dt_raw = _split_in_proj(cfg, zx[i])
        if heads_local:
            c0 = run.m[i] * Hl * Pd
            z = z[..., c0 : c0 + Hl * Pd]
            dt_raw = dt_raw[..., run.m[i] * Hl : (run.m[i] + 1) * Hl]
            sel = lambda t, c0=c0: torch.cat([t[..., c0 : c0 + Hl * Pd], t[..., d_in:]], dim=-1)
        else:
            sel = lambda t: t
        old = None if conv_old is None else conv_old[i]
        window = torch.cat([old, xbc], dim=1) if decode else F.pad(xbc, (0, 0, K - 1, 0))
        tails.append(window[:, -(K - 1) :, :])  # the whole conv state, every channel
        xc, _ = _causal_conv(cfg, sel(xbc), sel(conv_w[i]), sel(conv_b[i]), None if old is None else sel(old))
        gN = cfg.n_groups * cfg.d_state
        x = xc[..., : Hl * Pd]
        Bm, Cm = xc[..., Hl * Pd : Hl * Pd + gN], xc[..., Hl * Pd + gN :]
        a_log, dt_bias, d_skip = (t[i] for t in per_head)
        dt, a = _decays(cfg, dt_raw, dt_bias, a_log)
        f32 = torch.float32
        if decode:
            x = x.reshape(B_, Hl, Pd)
            G = (B_, cfg.n_groups, cfg.d_state)
            state = caches[i]["state"]
            if heads_local and not cache_split:
                state = state.narrow(1, run.m[i] * Hl, Hl)
            y, state = ssd_step(x, dt, a, Bm[:, 0].reshape(G), Cm[:, 0].reshape(G), state)
            y = y + d_skip.to(f32)[None, :, None] * x.to(f32)
        else:
            x = x.reshape(B_, L, Hl, Pd)
            G = (B_, L, cfg.n_groups, cfg.d_state)
            y, state = ssd_scan(cfg, x, dt, a, Bm.reshape(G), Cm.reshape(G))
            y = y + d_skip.to(f32)[None, None, :, None] * x.to(f32)
        states.append(state)
        gs.append(y.reshape(B_, L, Hl * Pd).to(h.dtype) * F.silu(z))
    out = run.row(_gated_norm(run, gs, p["norm_w"], heads_local), heads_local, p["out_proj"])
    if mode == "train":
        return out, [None] * run.n
    if heads_local and not cache_split:  # a replicated state holds every head
        states = all_gather(states, run.mesh, "model", 1)
    if cache_split:
        tails = [_block(t, i, run) for i, t in enumerate(tails)]
    if decode:
        for c, t, s in zip(caches, tails, states):
            c["conv"].copy_(t)
            c["state"].copy_(s)
        return out, caches
    return out, [{"conv": t.to(torch.float32), "state": s} for t, s in zip(tails, states)]
