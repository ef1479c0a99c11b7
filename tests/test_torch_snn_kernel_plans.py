"""CPU checks of the SNN kernels' designs: ``spike_matmul`` and ``sparse_accum``.

Each CUDA kernel's algorithm is emulated here in plain PyTorch, step by step
as the kernel takes it, and held to the JAX package exactly (no tolerance):

* ``spike_matmul`` splits the work into the planner's column tiles, 16-row
  strips and 256-deep K chunks.  A chunk takes the int8 route (its values
  narrowed to int8, summed into a fresh int32, then added into a uint32
  accumulator) when the strip's chunk of s and the tile's weights fit int8,
  byte planes of s where only the weights fit, two byte planes of the
  weights (high then low, in one int32) where the weights fit int16 and the
  chunk of s fits int8, else the int32 multiply-add route into the same
  accumulator.  Held to JAX ``spike_matmul(..., interpret=True)``.
* ``sparse_accum`` gives each event row a warp: per 128-column pass and
  32-slot group it takes the ballot of nonzero slots and walks its set bits
  in slot order, dealing them to the warp's two 16-lane groups, clamping
  channels into [0, n_in); the groups' sums are added at the end.  Held to
  JAX ``sparse_accum_ref`` and to the dense product.

``spike_matmul.plan`` is pure Python and is checked as ``quant_matmul.plan``
is in ``test_torch_kernel_plans.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_matmul.spike_matmul import spike_matmul as j_spike_matmul
from repro.kernels.sparse_accum.ref import sparse_accum_ref as j_sparse_accum_ref
from repro_torch.kernels.quant_matmul.spike_matmul import (
    CHUNK,
    MAX_BN,
    N_SMS,
    SMEM_CAP,
    STRIP,
    block_smem,
    plan,
    planes_fit,
    spike_matmul,
    spike_matmul_plain,
    weight_row_bytes,
)
from repro_torch.kernels.sparse_accum.ops import fixed_capacity_events

MASK32 = 0xFFFFFFFF


def _to_int32(acc64: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 with the same bits."""
    return torch.where(acc64 >= 2**31, acc64 - 2**32, acc64).to(torch.int32)


def _fits_i8(t: torch.Tensor) -> bool:
    return t.numel() == 0 or (int(t.min()) >= -128 and int(t.max()) <= 127)


def _fits_i16(t: torch.Tensor) -> bool:
    return t.numel() == 0 or (int(t.min()) >= -(2**15) and int(t.max()) < 2**15)


# ---------------------------------------------------------------------------
# spike_matmul
# ---------------------------------------------------------------------------


def emulate_spike_matmul(s: torch.Tensor, w: torch.Tensor):
    """csrc/spike_matmul.cu's arithmetic.  Returns the int32 result and the
    route of each (column tile, strip, chunk): "int8", ("planes", the byte
    planes that ran), "w16" (the two weight planes) or "int32"."""
    M, K = s.shape
    N = w.shape[1]
    p = plan(M, K, N)
    s64, w64 = s.to(torch.int64), w.to(torch.int64)
    acc = torch.zeros(M, N, dtype=torch.int64)  # uint32 values: the output
    routes = {}

    def add_pass(rows, cols, a, b, shift):
        """One tensor-core pass: an 8-bit chunk product in a fresh int32,
        shifted into place, added in uint32."""
        fresh = torch.zeros(a.shape[0], b.shape[1], dtype=torch.int32)
        fresh += a.to(torch.int32) @ b.to(torch.int32)  # |sum| <= 256 * 255 * 128 < 2^31
        part = (fresh.to(torch.int64) & MASK32) << shift
        acc[rows, cols] = (acc[rows, cols] + part) & MASK32

    for tile, c0 in enumerate(range(0, N, p.bn)):
        cols = slice(c0, min(N, c0 + p.bn))
        w8 = p.kind == "tensor" and _fits_i8(w[:, cols])  # the block's __syncthreads_or
        # the high plane's __syncthreads_or, where the plane fits the staging area
        w16 = not w8 and p.kind == "tensor" and planes_fit(K, p.bn) and _fits_i16(w[:, cols])
        for strip, r0 in enumerate(range(0, M, STRIP)):
            rows = slice(r0, min(M, r0 + STRIP))
            for chunk, k0 in enumerate(range(0, K, CHUNK)):
                ks = slice(k0, min(K, k0 + CHUNK))
                sc, wc = s64[rows, ks], w64[ks, cols]
                if w8 and _fits_i8(sc):  # the warp's __all_sync: one s8 x s8 pass
                    add_pass(rows, cols, sc, wc, 0)
                    routes[(tile, strip, chunk)] = "int8"
                elif w8:  # byte planes: b0..b2 unsigned, b3 signed
                    ran = []
                    for plane in range(4):
                        b = sc >> (8 * plane)
                        b = b & 0xFF if plane < 3 else ((b & 0xFF) ^ 0x80) - 0x80
                        if plane == 0 or bool(b.any()):  # the warp's __any_sync
                            add_pass(rows, cols, b, wc, 8 * plane)
                            ran.append(plane)
                    routes[(tile, strip, chunk)] = ("planes", tuple(ran))
                elif w16 and _fits_i8(sc):  # the high plane (s8), << 8, then the low (u8)
                    hi, lo = wc >> 8, wc & 0xFF
                    frag = (sc @ hi) << 8
                    assert int(frag.abs().max()) <= 2**30  # no int32 overflow
                    frag = frag + sc @ lo
                    assert int(frag.abs().max()) <= 2**30
                    acc[rows, cols] = (acc[rows, cols] + (frag & MASK32)) & MASK32
                    routes[(tile, strip, chunk)] = "w16"
                else:
                    for k in range(ks.start, ks.stop):  # one IMAD per k, mod 2**32
                        prod = (s64[rows, k, None] * w64[None, k, cols]) & MASK32
                        acc[rows, cols] = (acc[rows, cols] + prod) & MASK32
                    routes[(tile, strip, chunk)] = "int32"
    return _to_int32(acc), routes


def _jax_spike_matmul(s: np.ndarray, w: np.ndarray) -> np.ndarray:
    M, K = s.shape
    N = w.shape[1]
    if K == 0:  # the Pallas kernel cannot tile an empty K
        return np.asarray(jnp.matmul(jnp.asarray(s), jnp.asarray(w)))
    got = j_spike_matmul(jnp.asarray(s), jnp.asarray(w), bm=M, bn=N, bk=K, interpret=True)
    return np.asarray(got)


def _binary(M, K, seed, rate=0.15):
    return (np.random.default_rng(seed).random((M, K)) < rate).astype(np.int32)


def _w(K, N, seed, bits=6):
    lim = 2 ** (bits - 1)
    return np.random.default_rng(seed).integers(-lim + 1, lim, (K, N)).astype(np.int32)


def _check_spike(s_np, w_np):
    got, routes = emulate_spike_matmul(torch.from_numpy(s_np), torch.from_numpy(w_np))
    np.testing.assert_array_equal(got.numpy(), _jax_spike_matmul(s_np, w_np))
    return routes


@pytest.mark.parametrize(
    "M,K,N",
    [(64, 256, 128), (48, 128, 10), (37, 300, 24), (5, 33, 19), (16, 0, 8), (20, 520, 130)],
)
def test_spike_emulation_matches_jax_binary_w6(M, K, N):
    routes = _check_spike(_binary(M, K, seed=M + K), _w(K, N, seed=N))
    assert set(routes.values()) <= {"int8"}


@pytest.mark.parametrize("where", ["s", "w"])
@pytest.mark.parametrize("value", [-128, 127, 128])
def test_spike_range_edges(where, value):
    M, K, N = 32, 64, 16
    s, w = _binary(M, K, seed=3, rate=0.5), _w(K, N, seed=4, bits=8)
    if where == "s":
        s[5, 7] = value
    else:
        w[9, 3] = value
    routes = _check_spike(s, w)
    if where == "s":  # only strip 0 holds the value
        assert routes[(0, 0, 0)] == ("int8" if value < 128 else ("planes", (0,)))
        assert routes[(0, 1, 0)] == "int8"
    else:  # the weights decide for the whole column tile: 128 takes the weight planes
        assert set(routes.values()) == {"int8" if value < 128 else "w16"}


def test_one_value_of_200_sends_one_strip_to_byte_planes():
    M, K, N = 25 * 16, 256, 128
    s = _binary(M, K, seed=5)
    s[7 * STRIP + 3, 100] = 200
    routes = _check_spike(s, _w(K, N, seed=6))
    slow = {key: r for key, r in routes.items() if r != "int8"}
    assert slow == {(0, 7, 0): ("planes", (0,))}


def test_graded_chunk_is_its_own_route_across_k():
    """A large value in the second K chunk leaves the first chunk of the same
    strip on the one-pass route."""
    M, K, N = 32, 512, 16
    s = _binary(M, K, seed=7)
    s[20, 300] = 3999
    routes = _check_spike(s, _w(K, N, seed=8))
    assert routes[(0, 1, 0)] == "int8" and routes[(0, 1, 1)] == ("planes", (0, 1))
    assert routes[(0, 0, 1)] == "int8"


@pytest.mark.parametrize(
    "lo,hi", [(0, 4000), (-129, 130), (-(2**31), 2**31 - 1), (2**24 - 5, 2**24 + 5)]
)
def test_spike_byte_planes_are_exact_for_any_int32(lo, hi):
    rng = np.random.default_rng(abs(lo) % 1000 + 10)
    s = rng.integers(lo, hi, (24, 300), endpoint=True).astype(np.int32)
    s[0, 0], s[1, 1] = lo, hi
    routes = _check_spike(s, _w(300, 24, seed=11, bits=8))
    assert {r[0] for r in routes.values()} == {"planes"}


def test_spike_wraparound_3_times_2_pow_27():
    s = np.full((5, 16), 3, np.int32)
    w = np.full((16, 8), 2**27, np.int32)
    routes = _check_spike(s, w)
    assert set(routes.values()) == {"int32"}
    got, _ = emulate_spike_matmul(torch.from_numpy(s), torch.from_numpy(w))
    assert int(got[0, 0]) == -(2**31)


def test_spike_mixed_signs_and_full_int8_range():
    rng = np.random.default_rng(9)
    s = rng.integers(-128, 128, (40, 96)).astype(np.int32)
    w = rng.integers(-128, 128, (96, 40)).astype(np.int32)
    routes = _check_spike(s, w)
    assert set(routes.values()) == {"int8"}


@pytest.mark.parametrize("K,N", [(256, 128), (300, 24), (128, 10)])
@pytest.mark.parametrize("value", [-(2**15), -129, 128, 2**15 - 1])
def test_int16_weights_take_the_two_weight_planes(K, N, value):
    """Weights of 9-16 bits with spikes that fit int8: every tile through the
    high and the low weight plane, exact at the int16 edges.  A strip of
    -128s times a column of -2**15 sums to 2**30, the most the int32
    fragment holds."""
    M = 40
    s = _binary(M, K, seed=K + N, rate=0.5)
    s[:16, :] = -128
    w = _w(K, N, seed=N, bits=16)
    w[:, 0] = value
    routes = _check_spike(s, w)
    assert set(routes.values()) == {"w16"}


def test_graded_spikes_with_int16_weights_take_the_cuda_cores():
    """A chunk of graded spikes meets the int16 weights on the CUDA cores;
    the other chunks of the same block keep the weight planes."""
    M, K, N = 48, 512, 16
    s = _binary(M, K, seed=12)
    s[20, 300] = 200
    routes = _check_spike(s, _w(K, N, seed=13, bits=12))
    assert routes.pop((0, 1, 1)) == "int32"
    assert set(routes.values()) == {"w16"}


@pytest.mark.parametrize("value", [2**15, -(2**15) - 1, 2**27])
def test_weights_beyond_int16_stay_on_the_cuda_cores(value):
    M, K, N = 32, 256, 128
    w = _w(K, N, seed=14, bits=16)
    w[100, 7] = value
    routes = _check_spike(_binary(M, K, seed=15), w)
    assert set(routes.values()) == {"int32"}


def test_weight_planes_need_room_in_the_staging_area():
    """The high plane takes over the int32 staging area: up to K = 1024 at
    bn = 16 and 128 (the sweep's and the main path's shapes fit), 1280 at bn
    = 8; deeper int16 weights keep the CUDA cores."""
    for K, bn, fits in [(1024, 128, True), (1025, 128, False), (1024, 16, True),
                        (1025, 16, False), (1280, 8, True), (1281, 8, False)]:
        assert planes_fit(K, bn) is fits, (K, bn)
    for M, K, N in MAIN_SHAPES + [(4620, 256, 128), (4620, 128, 10), (231, 128, 128)]:
        p = plan(M, K, N, batch=512)
        assert p.kind == "tensor" and planes_fit(K, p.bn)
    routes = _check_spike(_binary(20, 1100, seed=16), _w(1100, 16, seed=17, bits=10))
    assert set(routes.values()) == {"int32"}


# ---------------------------------------------------------------------------
# spike_matmul.plan
# ---------------------------------------------------------------------------

MAIN_SHAPES = [(1024, 256, 128), (25600, 256, 128), (102400, 256, 128), (25600, 128, 10)]


@pytest.mark.parametrize("M", [1, 15, 16, 17, 1024, 25600, 64 * 65535 + 1, 10**7])
@pytest.mark.parametrize("K,N", [(256, 128), (128, 10), (16, 8), (5000, 300), (20000, 64)])
def test_plan_grid_limits(M, K, N):
    p = plan(M, K, N)
    blocks, col_tiles = p.grid
    strips = -(-M // STRIP)
    assert 1 <= blocks <= min(N_SMS, strips)  # one block an SM, none without a strip
    assert col_tiles == -(-N // p.bn) and col_tiles <= 65535
    assert p.bn in (8, 16, 32, 64, 128)
    assert p.smem <= SMEM_CAP
    # the blocks' contiguous strip ranges (csrc/spike_matmul.cu) cover every
    # strip once and differ in length by at most one
    ranges = [(strips * b // blocks, strips * (b + 1) // blocks) for b in range(blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == strips
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert max(e - s for s, e in ranges) - min(e - s for s, e in ranges) <= 1


def test_plan_is_a_function_of_the_shape():
    for M, K, N in MAIN_SHAPES + [(77, 33, 19), (5, 0, 8)]:
        assert plan(M, K, N) == plan(M, K, N)


def test_plan_at_the_main_path_shapes():
    for M, K, N in MAIN_SHAPES:
        p = plan(M, K, N)
        assert p.kind == "tensor" and p.grid == (min(N_SMS, M // STRIP), 1)
        assert p.bn == (128 if N == 128 else 16)
        assert p.smem == block_smem(K, p.bn) == p.bn * (CHUNK + 16) + CHUNK * (4 * p.bn + 16)
        assert weight_row_bytes(K) == CHUNK + 16


@pytest.mark.parametrize("batch", [1, 2, 64, 512, 2048, 65535])
@pytest.mark.parametrize(
    "M,K,N", [(20 * 231, 256, 128), (20 * 231, 128, 10), (231, 128, 128), (1, 16, 8), (231, 64, 40)]
)
def test_plan_with_a_candidate_axis(M, K, N, batch):
    """The population sweep's shapes (T = 20, 231 samples, the 256-128-10
    layers and an ATA-T recurrence): the candidates share the SMs, so the
    persistent blocks along M shrink as the batch grows, never below one.
    More than one candidate takes the candidate-axis kernel, built for 16
    and 128 columns only."""
    p, alone = plan(M, K, N, batch), plan(M, K, N)
    blocks, col_tiles = p.grid
    if batch == 1:
        assert p == alone
    else:
        assert p.kind == "tensor" and p.bn == (16 if N <= 16 else 128)
        assert p.smem == block_smem(K, p.bn) and col_tiles == -(-N // p.bn)
    assert 1 <= blocks <= -(-M // STRIP)
    assert blocks == max(1, min(-(-M // STRIP), -(-N_SMS // (col_tiles * batch))))
    if batch * col_tiles >= N_SMS:
        assert blocks == 1


def test_candidate_axis_products_match_each_candidate():
    """[M, K] @ [P, K, N], [P, M, K] @ [K, N] and [P, M, K] @ [P, K, N] equal
    the per-candidate products, wrapping like the JAX kernel; axes that
    differ are refused."""
    rng = np.random.default_rng(5)
    P, M, K, N = 3, 37, 20, 11
    s = torch.from_numpy(rng.integers(0, 3, (P, M, K)).astype(np.int32))
    w = torch.from_numpy(rng.integers(-(2**27), 2**27, (P, K, N)).astype(np.int32))
    for a, b in ((s[0], w), (s, w[1]), (s, w)):
        got = spike_matmul(a, b)
        assert got.shape == (P, M, N) and got.dtype == torch.int32
        for c in range(P):
            a_c, b_c = (a[c] if a.dim() == 3 else a), (b[c] if b.dim() == 3 else b)
            want = jnp.matmul(jnp.asarray(a_c.numpy()), jnp.asarray(b_c.numpy()))  # int32, wraps
            np.testing.assert_array_equal(got[c].numpy(), np.asarray(want))
            assert torch.equal(got[c], spike_matmul_plain(a_c, b_c))
    with pytest.raises(ValueError, match="candidate axes"):
        spike_matmul(s, w[:2])
    with pytest.raises(ValueError, match="do not chain"):
        spike_matmul(s, w.transpose(1, 2))


@pytest.mark.parametrize("N,bn", [(10, 16), (128, 128)])
def test_candidate_axis_plan_never_narrows_the_block(N, bn):
    """The candidate-axis kernel has no narrower block: where its block's
    weights do not fit shared memory, the call goes to the CUDA cores."""
    assert plan(1024, 2048, N, 4).bn == bn
    assert plan(1024, 2048, N, 4).kind == ("tensor" if bn == 16 else "simt")
    deep = plan(1024, 2**17, N, 4)
    assert deep.kind == "simt" and deep.smem == 0 and deep.bn == MAX_BN


def test_plan_narrows_the_block_for_deep_k_then_leaves_the_tensor_cores():
    assert plan(1024, 2048, 128).bn < 128
    deep = plan(1024, 2**17, 128)
    assert deep.kind == "simt" and deep.smem == 0 and deep.bn == MAX_BN
    assert all(plan(64, K, 64).kind == "tensor" for K in (1, 31, 32, 256, 4096, 20000))


# ---------------------------------------------------------------------------
# sparse_accum
# ---------------------------------------------------------------------------


# csrc/sparse_accum.cu: lanes that share one event, and events a warp takes
# at once (one a lane group)
GROUP_LANES = 16
GROUPS = 32 // GROUP_LANES


def emulate_sparse_accum(vals: torch.Tensor, idx: torch.Tensor, w: torch.Tensor):
    """csrc/sparse_accum.cu's arithmetic.  Returns the int32 result and, per
    row, the slots each lane group added, in the order it added them."""
    E, K = vals.shape
    n_in, N = w.shape
    w64 = w.to(torch.int64)
    out = torch.zeros(E, N, dtype=torch.int64)
    order = []
    for e in range(E):
        walked = [[] for _ in range(GROUPS)]
        for n0 in range(0, N, 128):  # a pass over 128 columns
            cols = slice(n0, min(N, n0 + 128))
            acc = torch.zeros(GROUPS, cols.stop - cols.start, dtype=torch.int64)
            for j0 in range(0, K, 32):
                lane_v = [int(vals[e, j]) if j < K else 0 for j in range(j0, j0 + 32)]
                live = sum(1 << lane for lane, v in enumerate(lane_v) if v != 0)  # ballot
                while live:  # each step: the GROUPS lowest set slots, one a group
                    for grp in range(GROUPS):
                        if not live:
                            break
                        j = j0 + (live & -live).bit_length() - 1  # __ffs - 1
                        live &= live - 1
                        ch = min(max(int(idx[e, j]), 0), n_in - 1)
                        acc[grp] = (acc[grp] + (int(vals[e, j]) * w64[ch, cols] & MASK32)) & MASK32
                        if n0 == 0:
                            walked[grp].append(j)
            out[e, cols] = acc.sum(0) & MASK32  # the groups' sums added (shuffles)
        order.append(walked)
    return _to_int32(out), order


def _events(E, n_in, budget, seed, rate=0.1, max_val=1):
    rng = np.random.default_rng(seed)
    on = rng.random((E, n_in)) < rate
    raster = np.where(on, rng.integers(1, max_val + 1, (E, n_in)), 0).astype(np.int32)
    vals, idx = fixed_capacity_events(torch.from_numpy(raster), budget)
    return raster, vals.numpy(), idx.numpy()


def _check_sparse(vals, idx, w):
    got, order = emulate_sparse_accum(*map(torch.from_numpy, (vals, idx, w)))
    clamped = np.clip(idx, 0, w.shape[0] - 1)
    want = j_sparse_accum_ref(jnp.asarray(vals), jnp.asarray(clamped), jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for e, walked in enumerate(order):  # only live slots, in slot order, dealt to the groups
        live = [j for j in range(vals.shape[1]) if vals[e, j] != 0]
        assert sorted(sum(walked, [])) == live
        assert all(g == sorted(g) for g in walked)
    return got


@pytest.mark.parametrize("N", [128, 40, 11, 300])
@pytest.mark.parametrize("max_val", [1, 37])
def test_sparse_emulation_matches_jax_and_dense(N, max_val):
    n_in, budget = 64, 32
    raster, vals, idx = _events(48, n_in, budget, seed=N + max_val, max_val=max_val)
    assert int((raster != 0).sum(-1).max()) <= budget
    w = _w(n_in, N, seed=N, bits=10)
    got = _check_sparse(vals, idx, w)
    dense = (raster.astype(np.int64) @ w.astype(np.int64)).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got.numpy(), dense)


def test_sparse_unsorted_lists_with_zeros_between_events():
    rng = np.random.default_rng(11)
    n_in, N, E, K = 64, 128, 12, 40
    _, vals, idx = _events(E, n_in, K, seed=12, rate=0.3, max_val=5)
    for e in range(E):  # scatter each row's slots, padding between the events
        perm = rng.permutation(K)
        vals[e], idx[e] = vals[e][perm], idx[e][perm]
    assert any(vals[e, 0] == 0 and vals[e].any() for e in range(E))
    _check_sparse(vals, idx, _w(n_in, N, seed=13, bits=8))


def test_sparse_channels_out_of_range_are_clamped():
    n_in, N = 16, 40
    vals = np.array([[1, 2, 0, 3, 1], [4, 0, 0, 0, 1]], np.int32)
    idx = np.array([[-5, 15, 99, 16, 2**30], [-1, 3, 3, 3, 0]], np.int32)
    w = _w(n_in, N, seed=14, bits=8)
    got = _check_sparse(vals, idx, w)
    want0 = 1 * w[0] + 2 * w[15] + 3 * w[15] + 1 * w[15]
    np.testing.assert_array_equal(got.numpy()[0], want0)


def test_sparse_single_row_and_wraparound():
    w = np.full((4, 11), 2**27, np.int32)
    vals = np.array([[3] * 16 + [0] * 17], np.int32)  # E = 1, K = 33
    idx = np.zeros_like(vals)
    got = _check_sparse(vals, idx, w)
    assert (got.numpy() == -(2**31)).all()
