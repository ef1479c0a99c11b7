"""The port's kernel modules against their JAX counterparts (exact equality).

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version to the JAX kernel (interpret mode) or its jnp oracle.  The
JAX ``sparse_accum`` Pallas kernel cannot run in interpret mode on this jax
(``pl.load`` is gone), so the sparse path is held to ``sparse_accum_ref``,
``fixed_capacity_events`` and the dense product.  The card-only tests
(marker ``cuda``) live in ``test_torch_cuda.py``, which imports no JAX so
that it also runs on a machine with a card and no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lif_scan.lif_scan import lif_scan as j_lif_scan
from repro.kernels.lif_scan.ops import fused_lif_window as j_fused_lif_window
from repro.kernels.quant_matmul.spike_matmul import spike_integrate as j_spike_integrate
from repro.kernels.quant_matmul.spike_matmul import spike_matmul as j_spike_matmul
from repro.kernels.sparse_accum.ops import fixed_capacity_events as j_fixed_capacity_events
from repro.kernels.sparse_accum.ref import sparse_accum_ref as j_sparse_accum_ref
from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.lif_scan.lif_scan import ataf_scan, lif_scan
from repro_torch.kernels.lif_scan.ops import fused_lif_window
from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul
from repro_torch.kernels.quant_matmul.spike_matmul import spike_integrate, spike_matmul
from repro_torch.kernels.sparse_accum.ops import fixed_capacity_events, sparse_accum_currents
from repro_torch.kernels.sparse_accum.sparse_accum import sparse_accum

# (T, B, N, theta, k, u_bits, reset_to_zero, block_b, block_n), as in tests/test_kernels.py
LIF_CASES = [
    (5, 8, 128, 500, 153, 16, False, 8, 128),
    (20, 16, 256, 900, 256, 12, False, 8, 128),
    (7, 8, 128, 300, 0, 10, True, 8, 128),
    (3, 16, 384, 100, 255, 16, True, 8, 128),
    (11, 8, 128, 50, 128, 8, False, 4, 64),
]


def _rng(seed):
    return np.random.default_rng(seed)


def _raster(rows, n_in, seed=0, rate=0.15, max_val=1):
    rng = _rng(seed)
    on = rng.random((rows, n_in)) < rate
    return np.where(on, rng.integers(1, max_val + 1, (rows, n_in)), 0).astype(np.int32)


def _weights(n_in, N, seed=2, lo=-500, hi=500):
    return _rng(seed).integers(lo, hi, (n_in, N)).astype(np.int32)


def _eq(a_torch, b):
    np.testing.assert_array_equal(np.asarray(a_torch.cpu()), np.asarray(b))


def _wrapped_dense(raster, w):
    """int64 product reduced mod 2**32 to int32: the wraparound contract."""
    return (raster.astype(np.int64) @ w.astype(np.int64)).astype(np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# spike_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N", [(128, 64, 128), (256, 256, 128), (24, 16, 8)])
def test_spike_matmul_matches_jax_kernel(M, K, N):
    s, w = _raster(M, K, seed=M), _weights(K, N, seed=K)
    want = j_spike_matmul(jnp.asarray(s), jnp.asarray(w), interpret=True)
    got = spike_matmul(torch.from_numpy(s), torch.from_numpy(w))
    assert got.dtype == torch.int32
    _eq(got, want)


def test_spike_matmul_wraparound():
    s = np.full((5, 16), 3, np.int32)
    w = np.full((16, 8), 2**27, np.int32)  # 16 * 3 * 2**27 overflows int32
    got = spike_matmul(torch.from_numpy(s), torch.from_numpy(w))
    _eq(got, _wrapped_dense(s, w))
    _eq(got, np.asarray(jnp.asarray(s) @ jnp.asarray(w)))


@pytest.mark.parametrize("T,B,K,N", [(6, 5, 33, 7), (4, 8, 64, 32)])
def test_spike_integrate_ragged_matches_jax(T, B, K, N):
    x = _raster(T * B, K, seed=T, max_val=3).reshape(T, B, K)
    w = _weights(K, N)
    want = j_spike_integrate(jnp.asarray(x), jnp.asarray(w))
    _eq(spike_integrate(torch.from_numpy(x), torch.from_numpy(w)), want)


# ---------------------------------------------------------------------------
# lif_scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,B,N,theta,k,u_bits,zero,bb,bn", LIF_CASES)
def test_lif_scan_matches_jax_kernel(T, B, N, theta, k, u_bits, zero, bb, bn):
    cur = _rng(T * N + k).integers(-300, 400, (T, B, N)).astype(np.int32)
    s1, u1 = j_lif_scan(
        jnp.asarray(cur), theta_q=theta, decay_k=k, u_bits=u_bits, reset_to_zero=zero,
        block_b=bb, block_n=bn, interpret=True,
    )
    s2, u2 = lif_scan(
        torch.from_numpy(cur), theta_q=theta, decay_k=k, u_bits=u_bits, reset_to_zero=zero
    )
    _eq(s2, s1)
    _eq(u2, u1)


def test_lif_scan_tensor_theta_and_negative_membrane():
    """A tensor theta is accepted; strongly negative currents drive u below
    zero, where the CG leak relies on arithmetic (floor) shifts."""
    cur = _rng(9).integers(-2000, 300, (9, 4, 16)).astype(np.int32)
    for k in (1, 77, 243, 256):
        s1, u1 = j_lif_scan(
            jnp.asarray(cur), theta_q=-40, decay_k=k, u_bits=12, block_b=4, block_n=16,
            interpret=True,
        )
        s2, u2 = lif_scan(
            torch.from_numpy(cur), theta_q=torch.tensor(-40, dtype=torch.int32), decay_k=k,
            u_bits=12,
        )
        assert int(u2.min()) < 0
        _eq(s2, s1)
        _eq(u2, u1)


def test_fused_lif_window_matches_jax():
    x = _raster(6 * 8, 40, seed=5).reshape(6, 8, 40)
    w = _weights(40, 24, lo=-30, hi=31)
    kw = dict(theta_q=60, decay_k=243, u_bits=10, reset_to_zero=False)
    s1, u1 = j_fused_lif_window(jnp.asarray(x), jnp.asarray(w), use_pallas=False, **kw)
    s2, u2 = fused_lif_window(torch.from_numpy(x), torch.from_numpy(w), **kw)
    _eq(s2, s1)
    _eq(u2, u1)


def test_lif_scan_rejects_bad_arguments():
    cur = torch.zeros(2, 3, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="decay_k"):
        lif_scan(cur, theta_q=1, decay_k=257)
    with pytest.raises(ValueError, match=r"\[T, B, N\]"):
        lif_scan(cur[0], theta_q=1, decay_k=0)


# ---------------------------------------------------------------------------
# sparse_accum and the AER encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,n_in,N", [(21, 19, 11), (96, 64, 40)], ids=["odd", "wide"])
@pytest.mark.parametrize("max_val", [1, 37], ids=["binary", "graded"])
def test_sparse_accum_matches_ref_and_dense(E, n_in, N, max_val):
    raster = _raster(E, n_in, rate=0.15, max_val=max_val)
    w = _weights(n_in, N)
    budget = int((raster != 0).sum(-1).max())
    jv, ji = j_fixed_capacity_events(jnp.asarray(raster), budget)
    tv, ti = fixed_capacity_events(torch.from_numpy(raster), budget)
    _eq(tv, jv)
    _eq(ti, ji)
    got = sparse_accum(tv, ti, torch.from_numpy(w))
    _eq(got, j_sparse_accum_ref(jv, ji, jnp.asarray(w)))
    _eq(got, raster @ w)


def test_sparse_accum_zero_events():
    w = torch.from_numpy(_weights(19, 11))
    vals = torch.zeros(7, 4, dtype=torch.int32)
    idx = torch.full((7, 4), 3, dtype=torch.int32)
    _eq(sparse_accum(vals, idx, w), np.zeros((7, 11), np.int32))


def test_sparse_accum_int32_wraparound_matches_dense():
    raster = np.full((5, 16), 3, np.int32)
    w = np.full((16, 8), 2**27, np.int32)
    vals, idx = fixed_capacity_events(torch.from_numpy(raster), 16)
    got = sparse_accum(vals, idx, torch.from_numpy(w))
    _eq(got, _wrapped_dense(raster, w))
    jv, ji = j_fixed_capacity_events(jnp.asarray(raster), 16)
    _eq(got, j_sparse_accum_ref(jv, ji, jnp.asarray(w)))


def test_over_budget_rows_keep_jax_top_k_events():
    """Insufficient budget: ties go to the lower channel exactly as
    ``jax.lax.top_k`` breaks them (``torch.topk`` would not)."""
    E, n_in, N, budget = 8, 24, 10, 4
    base = np.arange(1, n_in + 1, dtype=np.int32)
    distinct = np.stack([np.roll(base, r) for r in range(4)])
    ties = _rng(3).integers(0, 3, (4, n_in)).astype(np.int32)  # many equal values
    raster = np.concatenate([distinct, ties])
    raster[4, :5] = [1, 1, 1, 0, 1]
    w = _weights(n_in, N)
    jv, ji = j_fixed_capacity_events(jnp.asarray(raster), budget)
    tv, ti = fixed_capacity_events(torch.from_numpy(raster), budget)
    _eq(tv, jv)
    _eq(ti, ji)
    got = sparse_accum(tv, ti, torch.from_numpy(w))
    _eq(got, j_sparse_accum_ref(jv, ji, jnp.asarray(w)))
    v3, i3 = fixed_capacity_events(torch.tensor([1, 1, 1, 0, 1]), 3)
    assert i3.tolist() == [0, 1, 2] and v3.tolist() == [1, 1, 1]


@pytest.mark.parametrize("max_val", [1, 11], ids=["binary", "graded"])
def test_sparse_accum_currents_lowerings_agree(max_val):
    T, B, n_in, N = 6, 4, 64, 32
    raster = _raster(T * B, n_in, rate=0.1, max_val=max_val).reshape(T, B, n_in)
    w = _weights(n_in, N)
    budget = int((raster != 0).sum(-1).max())
    dense = np.einsum("tbk,kn->tbn", raster, w)
    x, wt = torch.from_numpy(raster), torch.from_numpy(w)
    for kw in (dict(f32_exact=True), dict(f32_exact=False), dict(use_pallas=True)):
        got = sparse_accum_currents(x, wt, budget, **kw)
        assert got.dtype == torch.int32
        _eq(got, dense)


# ---------------------------------------------------------------------------
# Wrapper contract: plain version only for CPU tensors, counted launches
# ---------------------------------------------------------------------------


def test_wrappers_count_no_launch_on_cpu():
    before = kernels.launch_counts()
    spike_matmul(torch.ones(3, 4, dtype=torch.int32), torch.ones(4, 2, dtype=torch.int32))
    lif_scan(torch.ones(2, 3, 4, dtype=torch.int32), theta_q=1, decay_k=128)
    regs = torch.ones(2, dtype=torch.int32)
    ataf_scan(torch.ones(2, 3, 1, 4, dtype=torch.int32), w_self=regs, theta_q=regs, decay_k=regs)
    sparse_accum(
        torch.ones(3, 2, dtype=torch.int32), torch.zeros(3, 2, dtype=torch.int32),
        torch.ones(4, 5, dtype=torch.int32),
    )
    quant_matmul(torch.ones(3, 4), torch.ones(4, 2, dtype=torch.int8), torch.ones(2), bits=8)
    flash_attention(torch.ones(1, 2, 3, 4), torch.ones(1, 1, 3, 4), torch.ones(1, 1, 3, 4))
    assert kernels.launch_counts() == before
    assert set(before) == {
        "spike_matmul", "lif_scan", "ataf_scan", "sparse_accum", "quant_matmul", "flash_attention",
    }


class _OtherDevice(torch.Tensor):
    """A meta tensor that reports a device type no wrapper has a kernel for."""

    @property
    def device(self):
        return torch.device("xpu")


def _other(*shape, dtype=torch.float32):
    return torch.Tensor._make_subclass(_OtherDevice, torch.empty(*shape, dtype=dtype, device="meta"))


def test_wrappers_refuse_devices_without_a_kernel():
    m = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        spike_matmul(torch.empty(3, 4, dtype=torch.int32, device=m),
                     torch.empty(4, 2, dtype=torch.int32, device=m))
    with pytest.raises(ValueError, match="no kernel"):
        lif_scan(torch.empty(2, 3, 4, dtype=torch.int32, device=m), theta_q=1, decay_k=0)
    with pytest.raises(ValueError, match="no kernel"):
        sparse_accum(torch.empty(3, 2, dtype=torch.int32, device=m),
                     torch.empty(3, 2, dtype=torch.int32, device=m),
                     torch.empty(4, 5, dtype=torch.int32, device=m))
    # the two LM kernels take meta tensors for the dry run (an allocation,
    # no launch: tests/test_torch_dryrun.py) and refuse every other device
    with pytest.raises(ValueError, match="no kernel"):
        quant_matmul(_other(3, 4), _other(4, 2, dtype=torch.int8), _other(2))
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(*(_other(1, 2, 3, 4) for _ in range(3)))
    assert quant_matmul(torch.empty(3, 4, device=m), torch.empty(4, 2, dtype=torch.int8, device=m),
                        torch.empty(2, device=m)).device == m
    assert flash_attention(*(torch.empty(1, 2, 3, 4, device=m) for _ in range(3))).device == m
    with pytest.raises(ValueError, match="do not chain"):
        spike_matmul(torch.ones(3, 4, dtype=torch.int32), torch.ones(5, 2, dtype=torch.int32))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_library_path_tracks_source_and_flags():
    a = build._library_path("lif_scan")
    assert a == build._library_path("lif_scan")
    assert a.parent == build.BUILD_DIR and a.name.startswith("lif_scan-")
    assert a != build._library_path("sparse_accum")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
