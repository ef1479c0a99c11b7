"""CPU checks of the two tensor-core kernels' designs.

``quant_matmul``'s planner is pure Python and is checked here: it depends on
the shape alone, the decode regime ends well below M = 256, the split of K
depends on K and N only, every decode shape of the LM fills the card, and
the workspace holds one f32 partial per split.

``flash_attention``'s bf16 kernel multiplies P V on the tensor cores with
P split into bf16 hi + lo.  A plain PyTorch emulation of its per-tile
arithmetic is held to the tolerance of ``chip_smoke.py`` phase 2 on that
phase's cases at a reduced head count; rounding P to a single bf16 (the
planted fault) must fail the soft-capped case.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_attention_ref
from repro_torch.kernels.quant_matmul.quant_matmul import (
    N_SMS,
    SKINNY_BK,
    SKINNY_MAX_M,
    plan,
)

# (K, N) of the LM's quantized matmuls (stablelm-1.6b: wq wk wv wo, w_gate
# w_up, w_down), and the splits the planner gives them
LM_KN = [(2048, 2048), (2048, 5632), (5632, 2048)]
LM_SPLITS = {(2048, 2048): 16, (2048, 5632): 4, (5632, 2048): 15}


def test_plan_is_a_function_of_the_shape():
    for M, K, N in [(8, 2048, 5632), (4096, 5632, 2048), (5, 96, 24)]:
        assert plan(M, K, N) == plan(M, K, N)
    assert plan(8, 2048, 2048, x_bf16=False).kind == "simt"
    assert plan(4096, 2048, 2048, x_bf16=False).kind == "simt"


@pytest.mark.parametrize("M", [1, 8, 63, 64, 65, 128, 255, 256, 4096])
def test_regime_threshold_is_below_256(M):
    assert SKINNY_MAX_M < 256
    want = "skinny" if M <= SKINNY_MAX_M else "wide"
    assert all(plan(M, K, N).kind == want for K, N in LM_KN)


@pytest.mark.parametrize("K,N", LM_KN + [(1000, 2048), (33, 70), (4104, 320), (130, 4096)])
def test_split_depends_on_k_and_n_only(K, N):
    splits = {plan(M, K, N).splits for M in range(1, SKINNY_MAX_M + 1)}
    assert len(splits) == 1
    s = splits.pop()
    n_stages = -(-K // SKINNY_BK)
    chunk = -(-n_stages // s)
    assert 1 <= s <= max(n_stages, 1)
    assert (s - 1) * chunk < n_stages  # no split is empty


@pytest.mark.parametrize("K,N", LM_KN)
def test_every_decode_shape_fills_the_card(K, N):
    p = plan(8, K, N)
    assert p.kind == "skinny" and p.splits == LM_SPLITS[(K, N)]
    assert p.blocks >= 2 * N_SMS


@pytest.mark.parametrize("M,K,N", [(8, 2048, 2048), (8, 5632, 2048), (1, 2048, 5632),
                                   (3, 64, 128), (256, 2048, 2048), (4096, 5632, 2048)])
def test_workspace_holds_one_partial_per_split(M, K, N):
    p = plan(M, K, N)
    if p.kind == "wide":
        assert (p.splits, p.workspace) == (1, 0)
        assert p.grid == (-(-N // 128), -(-M // 128), 1)
    else:
        assert p.workspace == (p.splits * M * N if p.splits > 1 else 0)
        assert p.grid == (-(-N // 64), p.splits, -(-M // 16))


# ---------------------------------------------------------------------------
# flash_attention: the rounding of P in the P V product
# ---------------------------------------------------------------------------

# chip_smoke.py's FA_TOL: one bf16 ulp of the output, atol for values near 0
FA_TOL = dict(rtol=2**-7, atol=2e-3)


def tiled_flash(q, k, v, *, causal, window=None, softcap=None, p_round="hilo"):
    """The bf16 kernel's arithmetic over 64-key tiles in plain PyTorch: f32
    scores, online softmax with l from the f32 p, and P V with P rounded as
    ``p_round`` says ("hilo": bf16 hi + bf16 lo; "bf16": one bf16; "f32")."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = D**-0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:3], NEG_INF)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(qf.shape)
    qp = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, 64):
        kt, vt = kf[:, :, k0 : k0 + 64], vf[:, :, k0 : k0 + 64]
        s = qf @ kt.transpose(-1, -2) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kp = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones(Sq, kt.shape[2], dtype=torch.bool)
        if causal:
            ok &= qp - kp >= 0
        if window is not None:
            ok &= qp - kp < window
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = corr * l + p.sum(-1)
        if p_round == "f32":
            pv = p @ vt
        else:
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vt
            if p_round == "hilo":
                pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _tol_used(got, want, tol):
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


# chip_smoke phase 2's bf16 cases (and a card test's D = 128 window case),
# heads cut from 32 / 8 / 4 / 2
FA_CASES = [
    ((1, 1, 4096, 64), 1.0, dict(causal=True)),
    ((1, 2, 1024, 64), 8.0, dict(causal=True, window=64, softcap=30.0)),
    ((2, 2, 300, 64), 1.0, dict(causal=True)),
    ((1, 1, 1024, 128), 1.0, dict(causal=True, window=256)),
]


def _fa_inputs(shape, q_mult, seed):
    rng = np.random.default_rng(seed)
    mk = lambda: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    q, k, v = mk(), mk(), mk()
    return (q.float() * q_mult).to(torch.bfloat16), k, v


@pytest.mark.parametrize("shape,q_mult,kw", FA_CASES)
def test_p_split_into_hi_and_lo_keeps_the_tolerance(shape, q_mult, kw):
    q, k, v = _fa_inputs(shape, q_mult, seed=shape[2])
    want = flash_attention_ref(q, k, v, **kw)
    used = {
        r: _tol_used(tiled_flash(q, k, v, **kw, p_round=r), want, FA_TOL) for r in ("f32", "hilo")
    }
    assert used["hilo"] <= 1, used
    assert used["f32"] <= 1, used


def test_p_rounded_to_one_bf16_fails_the_softcapped_case():
    shape, q_mult, kw = FA_CASES[1]
    q, k, v = _fa_inputs(shape, q_mult, seed=shape[2])
    want = flash_attention_ref(q, k, v, **kw)
    assert _tol_used(tiled_flash(q, k, v, **kw, p_round="hilo"), want, FA_TOL) <= 1
    assert _tol_used(tiled_flash(q, k, v, **kw, p_round="bf16"), want, FA_TOL) > 1
