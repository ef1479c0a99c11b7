"""Mamba-2 (SSD, state-space duality) mixer: chunked train path + O(1) decode.

Port of ``repro/models/mamba2.py``.  Implements the SSD algorithm of
arXiv:2405.21060: within a chunk the output is a masked quadratic form
(attention-like); across chunks a linear recurrence carries the [H, P, N]
state -- JAX's ``lax.scan`` over the chunks becomes a Python loop.  The
per-step decay ``a = exp(dt * A)`` is the paper's leaky-integrator
coefficient generalised: ``decay_quant_bits`` snaps it onto the
Coefficient Generator's k/2^bits grid with a straight-through gradient.

The SSD runs in plain PyTorch on every device, as JAX runs it outside any
Pallas kernel; the projections go through ``qdot`` (the ``quant_matmul``
kernel for quantized weights on the card).  Dtypes follow JAX step by
step: the f32 ``conv_w`` promotes the conv output to f32, the scan is f32,
and ``y`` returns to the input's dtype before the gated norm.

Shapes: x [B, L, H, P]; B, C [B, L, G, N]; dt [B, L, H]; states [B, H, P, N].
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.core.precision import qdot
from repro_torch.models.common import FSDP, TP, dense, rms_norm

__all__ = ["SSMConfig", "ssm_template", "ssm_apply", "ssm_decode_step", "ssm_cache_init"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    decay_quant_bits: int | None = None  # CG-grid quantization of exp(dt*A)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def ssm_template(cfg: SSMConfig) -> dict:
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + cfg.n_heads
    return {
        "in_proj": dense(cfg.d_model, d_in_proj, logical=(FSDP, TP)),
        "conv_w": dense(cfg.d_conv, cfg.conv_dim, logical=(None, TP), scale=0.5),
        "conv_b": dense(cfg.conv_dim, logical=(TP,), init="zeros"),
        "a_log": dense(cfg.n_heads, logical=(TP,), init="ones"),
        "d_skip": dense(cfg.n_heads, logical=(TP,), init="ones"),
        "dt_bias": dense(cfg.n_heads, logical=(TP,), init="zeros"),
        "norm_w": dense(cfg.d_inner, logical=(TP,), init="ones"),
        "out_proj": dense(cfg.d_inner, cfg.d_model, logical=(TP, FSDP)),
    }


def _split_in_proj(cfg: SSMConfig, zxbcdt: torch.Tensor):
    d_in = cfg.d_inner
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : d_in + cfg.conv_dim]
    dt = zxbcdt[..., d_in + cfg.conv_dim :]
    return z, xbc, dt


def _causal_conv(cfg: SSMConfig, xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv over time. xbc [B, L, conv_dim].

    With ``conv_state`` ([B, d_conv-1, conv_dim]) performs the streaming
    update (decode).  Returns (out, new_state)."""
    K = cfg.d_conv
    if conv_state is not None:
        window = torch.cat([conv_state, xbc], dim=1)  # [B, K-1+L, C]
    else:
        window = F.pad(xbc, (0, 0, K - 1, 0))
    new_state = window[:, -(K - 1) :, :]
    L = xbc.shape[1]
    out = sum(window[:, i : i + L, :] * conv_w[i][None, None, :] for i in range(K))
    return F.silu(out + conv_b[None, None, :]), new_state


def _decays(cfg: SSMConfig, dt_raw, dt_bias, a_log):
    """dt (softplus) and per-step decay a = exp(dt * A), A = -exp(a_log).

    With ``decay_quant_bits`` the decay is snapped to the Coefficient
    Generator grid (k/2^bits, round half to even) with a straight-through
    gradient -- the paper's leak-precision knob applied to the SSD
    recurrence."""
    u = dt_raw.to(torch.float32) + dt_bias[None, None, :]
    dt = torch.logaddexp(u, torch.zeros_like(u))  # jax.nn.softplus
    a = torch.exp(dt * -torch.exp(a_log.to(torch.float32))[None, None, :])
    if cfg.decay_quant_bits is not None:
        levels = float(1 << cfg.decay_quant_bits)
        a_q = torch.round(a * levels) / levels
        a = a + (a_q - a).detach()
    return dt, a


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """log_a [..., T] -> cumulative-decay matrix M[i, j] = sum_{k=j+1..i} log_a_k
    (lower-triangular; -inf above the diagonal, chosen before any ``exp`` so
    that the masked entries carry no gradient)."""
    T = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    M = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(T, device=log_a.device)
    lower = idx[:, None] >= idx[None, :]
    return torch.where(lower, M, torch.tensor(-torch.inf, dtype=M.dtype, device=M.device))


def ssd_scan(cfg: SSMConfig, x, dt, a, B, C, init_state=None):
    """Chunked SSD. Returns (y [B,L,H,P], final_state [B,H,P,N]), both f32."""
    Bb, L, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    ch = min(cfg.chunk, L)
    if L % ch:
        raise ValueError(f"seq {L} not divisible by chunk {ch}")
    nc = L // ch
    rep = H // G  # heads per B/C group
    f32 = torch.float32

    xc = x.reshape(Bb, nc, ch, H, Pd)
    dtc = dt.reshape(Bb, nc, ch, H)
    ac = a.reshape(Bb, nc, ch, H)
    Bc = B.reshape(Bb, nc, ch, G, N)
    Cc = C.reshape(Bb, nc, ch, G, N)
    log_a = torch.log(torch.clamp(ac, min=1e-20))  # [B,nc,ch,H]

    # ---- intra-chunk (quadratic, attention-like) ----
    Lmat = torch.exp(_segsum(log_a.permute(0, 1, 3, 2)))  # [B,nc,H,ch,ch]
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc.to(f32), Bc.to(f32))
    CB = CB.repeat_interleave(rep, dim=2)  # [B,nc,H,i,j]
    scores = CB * Lmat
    xdt = xc.to(f32) * dtc[..., None]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores, xdt)

    # ---- chunk states: state_c = sum_j decay(j..end) B_j (dt x)_j ----
    cum = torch.cumsum(log_a, dim=2)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    Brep = Bc.repeat_interleave(rep, dim=3)  # [B,nc,ch,H,N]
    chunk_state = torch.einsum(
        "bcjhn,bcjhp->bchpn", Brep.to(f32) * decay_to_end[..., None], xdt
    )  # [B,nc,H,P,N]

    # ---- inter-chunk recurrence over nc (sequential; nc is small) ----
    chunk_decay = torch.exp(torch.sum(log_a, dim=2))  # [B,nc,H]
    h = (
        init_state.to(f32)
        if init_state is not None
        else torch.zeros((Bb, H, Pd, N), dtype=f32, device=x.device)
    )
    h_in = []
    for c in range(nc):
        h_in.append(h)  # the state *entering* chunk c
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    final_state = h
    h_in = torch.stack(h_in, dim=1)  # [B,nc,H,P,N]

    # ---- inter-chunk contribution: C_i · (decay(0..i) * h_in) ----
    decay_from_start = torch.exp(cum)
    Crep = Cc.repeat_interleave(rep, dim=3)  # [B,nc,ch,H,N]
    y_inter = torch.einsum(
        "bcihn,bchpn->bcihp", Crep.to(f32) * decay_from_start[..., None], h_in
    )
    y = (y_intra + y_inter).reshape(Bb, L, H, Pd)
    return y, final_state


def _bc(cfg: SSMConfig, xbc):
    """The B and C columns of the conv output, [..., G, N] each."""
    gN = cfg.n_groups * cfg.d_state
    Bmat = xbc[..., cfg.d_inner : cfg.d_inner + gN]
    Cmat = xbc[..., cfg.d_inner + gN :]
    shape = (*xbc.shape[:-1], cfg.n_groups, cfg.d_state)
    return Bmat.reshape(shape), Cmat.reshape(shape)


def ssm_apply(cfg: SSMConfig, params, x_tokens, init_state=None):
    """Full mixer: in_proj -> conv -> SSD -> gated norm -> out_proj.

    x_tokens [B, L, D] -> (y [B, L, D], final_state f32, conv_state)."""
    B_, L, _ = x_tokens.shape
    zxbcdt = qdot(x_tokens, params["in_proj"])
    z, xbc, dt_raw = _split_in_proj(cfg, zxbcdt)
    xbc, conv_state = _causal_conv(cfg, xbc, params["conv_w"], params["conv_b"])
    x = xbc[..., : cfg.d_inner].reshape(B_, L, cfg.n_heads, cfg.head_dim)
    Bmat, Cmat = _bc(cfg, xbc)
    dt, a = _decays(cfg, dt_raw, params["dt_bias"], params["a_log"])

    y, state = ssd_scan(cfg, x, dt, a, Bmat, Cmat, init_state)
    y = y + params["d_skip"].to(torch.float32)[None, None, :, None] * x.to(torch.float32)
    y = y.reshape(B_, L, cfg.d_inner).to(x_tokens.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"])
    return qdot(y, params["out_proj"]), state, conv_state


def ssm_cache_template(cfg: SSMConfig, batch: int, dtype=torch.float32) -> dict:
    """{name: (shape, dtype)} of one layer's decode cache."""
    return {
        "conv": ((batch, cfg.d_conv - 1, cfg.conv_dim), dtype),
        "state": ((batch, cfg.n_heads, cfg.head_dim, cfg.d_state), dtype),
    }


def ssm_cache_init(cfg: SSMConfig, batch: int, dtype=torch.float32, device="cuda") -> dict:
    """Zeroed decode cache on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return {
        name: torch.zeros(shape, dtype=dt, device=device)
        for name, (shape, dt) in ssm_cache_template(cfg, batch, dtype).items()
    }


def ssd_step(x, dt, a, Bmat, Cmat, state):
    """One step of the recurrence: x [B,H,P], dt / a [B,1,H], Bmat / Cmat
    [B,G,N] and the f32 state [B,H,P,N] -> (y [B,H,P] f32, before the skip
    term, and the new state).  A block of heads (with their groups' B / C)
    gives its block."""
    rep = x.shape[1] // Bmat.shape[1]
    Brep = Bmat.repeat_interleave(rep, dim=1)  # [B,H,N]
    Crep = Cmat.repeat_interleave(rep, dim=1)
    f32 = torch.float32
    xdt = x.to(f32) * dt[:, 0, :, None]  # [B,H,P]
    state = state * a[:, 0, :, None, None] + torch.einsum("bhn,bhp->bhpn", Brep.to(f32), xdt)
    return torch.einsum("bhn,bhpn->bhp", Crep.to(f32), state), state


def ssm_decode_step(cfg: SSMConfig, params, cache, x_token):
    """One-token decode: O(1) in context length. x_token [B, 1, D].

    Returns (y [B, 1, D], {"conv", "state"}): new tensors; ``cache`` is not
    written (``transformer.decode_step`` copies them into its caches)."""
    B_ = x_token.shape[0]
    zxbcdt = qdot(x_token, params["in_proj"])
    z, xbc, dt_raw = _split_in_proj(cfg, zxbcdt)
    xbc, conv_state = _causal_conv(cfg, xbc, params["conv_w"], params["conv_b"], cache["conv"])
    x = xbc[..., : cfg.d_inner].reshape(B_, cfg.n_heads, cfg.head_dim)
    Bmat, Cmat = _bc(cfg, xbc[:, 0])  # [B,G,N]
    dt, a = _decays(cfg, dt_raw, params["dt_bias"], params["a_log"])  # [B,1,H]

    y, state = ssd_step(x, dt, a, Bmat, Cmat, cache["state"])
    f32 = torch.float32
    y = y + params["d_skip"].to(f32)[None, :, None] * x.to(f32)
    y = y.reshape(B_, 1, cfg.d_inner).to(x_token.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"])
    return qdot(y, params["out_proj"]), {"conv": conv_state, "state": state}
