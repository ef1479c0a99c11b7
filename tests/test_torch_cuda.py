"""Card-only tests: each CUDA kernel and the main path on the card.

Every test here carries the ``cuda`` marker and skips, inside the test,
when ``torch.cuda.is_available()`` is false.  The file imports no JAX, so
it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CPU run of the same code is the reference here: on the CPU every
wrapper takes its plain version, and ``test_torch_*.py`` hold that to JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import backend as tbe
from repro_torch.core import network as tnet
from repro_torch.core import snn_layer as tsl
from repro_torch.kernels.lif_scan.lif_scan import ataf_scan, lif_scan
from repro_torch.kernels.lif_scan.ref import ataf_scan_ref, lif_scan_ref
from repro_torch.kernels.quant_matmul.spike_matmul import spike_matmul, spike_matmul_plain
from repro_torch.kernels.sparse_accum.ops import fixed_capacity_events
from repro_torch.kernels.sparse_accum.ref import sparse_accum_ref
from repro_torch.kernels.sparse_accum.sparse_accum import sparse_accum
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.snn_engine import SNNRequest, SNNServeEngine
from repro_torch.serve.streaming import StreamConfig, StreamSessionManager

pytestmark = pytest.mark.cuda

# (T, B, N, theta, k, u_bits, reset_to_zero), the lif cases of tests/test_kernels.py
LIF_CASES = [
    (5, 8, 128, 500, 153, 16, False),
    (20, 16, 256, 900, 256, 12, False),
    (7, 8, 128, 300, 0, 10, True),
    (3, 16, 384, 100, 255, 16, True),
    (11, 8, 128, 50, 128, 8, False),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _raster(rows, n_in, seed=0, rate=0.15, max_val=1):
    rng = np.random.default_rng(seed)
    on = rng.random((rows, n_in)) < rate
    return np.where(on, rng.integers(1, max_val + 1, (rows, n_in)), 0).astype(np.int32)


def _wrapped_dense(s, w):
    return (s.astype(np.int64) @ w.astype(np.int64)).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("M,K,N", [(25 * 64, 256, 128), (77, 33, 19), (5, 16, 8), (64, 0, 8)])
def test_spike_matmul_kernel_matches_plain(cuda, M, K, N):
    s_np = _raster(M, K, seed=M, max_val=3)
    w_np = np.random.default_rng(K).integers(-(2**27), 2**27, (K, N)).astype(np.int32)
    s, w = torch.from_numpy(s_np).to(cuda), torch.from_numpy(w_np).to(cuda)
    n0 = spike_matmul.launches
    got = spike_matmul(s, w)
    torch.cuda.synchronize()
    assert spike_matmul.launches == n0 + 1
    assert torch.equal(got, spike_matmul_plain(s, w))
    np.testing.assert_array_equal(got.cpu().numpy(), _wrapped_dense(s_np, w_np))


def _w6(K, N, seed):
    return np.random.default_rng(seed).integers(-31, 32, (K, N)).astype(np.int32)


@pytest.mark.parametrize(
    "M,K,N", [(25 * 1024, 256, 128), (25 * 1024, 128, 10), (1000, 520, 130), (40, 30000, 8)]
)
def test_spike_matmul_mixed_raster_matches_plain(cuda, M, K, N):
    """Binary strips in one int8 pass beside strips whose graded values
    (128..3999, and one of -129) send their chunk to byte planes; K = 30000
    is too deep for the shared-memory weights and runs on the CUDA cores."""
    rng = np.random.default_rng(M + K)
    s_np = _raster(M, K, seed=K, rate=0.12)
    for strip in rng.choice(M // 16, min(5, M // 16), replace=False):
        r, k = 16 * strip + rng.integers(0, 16), rng.integers(0, K)
        s_np[r, k] = rng.integers(128, 4000)
    s_np[3, K - 1] = -129
    w_np = _w6(K, N, seed=N)
    s, w = torch.from_numpy(s_np).to(cuda), torch.from_numpy(w_np).to(cuda)
    got = spike_matmul(s, w)
    torch.cuda.synchronize()
    assert torch.equal(got, spike_matmul_plain(s, w))
    np.testing.assert_array_equal(got.cpu().numpy(), _wrapped_dense(s_np, w_np))


@pytest.mark.parametrize("kernel", ["spike_matmul", "sparse_accum"])
def test_kernels_take_rows_past_the_first_versions_grid(cuda, kernel):
    """The first versions refused M > 64 * 65535 and E > 16 * 65535; both
    kernels now loop or launch over rows with no such limit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    if kernel == "spike_matmul":
        s = (torch.rand(64 * 65535 + 1, 16, device=cuda, generator=gen) < 0.2).to(torch.int32)
        w = torch.from_numpy(_w6(16, 8, seed=1)).to(cuda)
        got = spike_matmul(s, w)
        torch.cuda.synchronize()
        assert torch.equal(got, spike_matmul_plain(s, w))
    else:
        E = 16 * 65535 + 1
        vals = torch.randint(0, 3, (E, 4), device=cuda, generator=gen, dtype=torch.int32)
        idx = torch.randint(0, 256, (E, 4), device=cuda, generator=gen, dtype=torch.int32)
        w = torch.from_numpy(_w6(256, 128, seed=2)).to(cuda)
        got = sparse_accum(vals, idx, w)
        torch.cuda.synchronize()
        assert torch.equal(got, sparse_accum_ref(vals, idx, w))


@pytest.mark.parametrize("N", [128, 40, 11, 300])
def test_sparse_accum_unsorted_lists_match_plain(cuda, N):
    """Slots in any order, padding between the events."""
    rng = np.random.default_rng(N)
    raster = torch.from_numpy(_raster(2048, 256, seed=N, rate=0.1, max_val=9))
    vals, idx = fixed_capacity_events(raster, 64)
    perm = torch.from_numpy(np.argsort(rng.random((2048, 64)), axis=1))
    vals, idx = vals.gather(1, perm).contiguous(), idx.gather(1, perm).contiguous()
    assert bool(((vals[:, 0] == 0) & (vals.sum(1) > 0)).any())
    w = torch.from_numpy(np.random.default_rng(1).integers(-500, 500, (256, N)).astype(np.int32))
    got = sparse_accum(vals.to(cuda), idx.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sparse_accum_ref(vals, idx, w))
    dense = _wrapped_dense(raster.numpy(), w.numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), dense)


@pytest.mark.parametrize("T,B,N,theta,k,u_bits,zero", LIF_CASES)
def test_lif_scan_kernel_matches_plain(cuda, T, B, N, theta, k, u_bits, zero):
    cur = np.random.default_rng(T * N + k).integers(-300, 400, (T, B, N)).astype(np.int32)
    cur_t = torch.from_numpy(cur)
    s1, u1 = lif_scan(cur_t.to(cuda), theta_q=theta, decay_k=k, u_bits=u_bits, reset_to_zero=zero)
    s2, u2 = lif_scan_ref(cur_t, theta, k, u_bits, zero)
    torch.cuda.synchronize()
    assert torch.equal(s1.cpu(), s2) and torch.equal(u1.cpu(), u2)


def test_lif_scan_scalar_call_reads_theta_on_the_card(cuda):
    """A single window is the kernel's candidate form with P = 1: theta as a
    device scalar (as FusedBackend passes it) gives what an int gives, and
    the launch is one."""
    cur = np.random.default_rng(2).integers(-300, 400, (9, 8, 40)).astype(np.int32)
    cur = torch.from_numpy(cur)
    theta = torch.tensor(350, dtype=torch.int32, device=cuda)
    n0 = lif_scan.launches
    s1, u1 = lif_scan(cur.to(cuda), theta_q=theta, decay_k=243)
    s2, u2 = lif_scan(cur.to(cuda), theta_q=350, decay_k=243)
    torch.cuda.synchronize()
    assert lif_scan.launches == n0 + 2
    s3, u3 = lif_scan_ref(cur, 350, 243)
    assert torch.equal(s1.cpu(), s3) and torch.equal(u1.cpu(), u3)
    assert torch.equal(s2.cpu(), s3) and torch.equal(u2.cpu(), u3)
    with pytest.raises(ValueError, match="one int32 value"):
        lif_scan(cur.to(cuda), theta_q=theta.to(torch.int64), decay_k=243)


@pytest.mark.parametrize("max_val,rate", [(1, 0.1), (37, 0.1), (1, 0.4)])
def test_sparse_accum_kernel_matches_plain(cuda, max_val, rate):
    raster = torch.from_numpy(_raster(2048, 256, rate=rate, max_val=max_val)).to(cuda)
    w = torch.from_numpy(np.random.default_rng(1).integers(-500, 500, (256, 128))).to(
        device=cuda, dtype=torch.int32
    )
    vals, idx = fixed_capacity_events(raster, 64)  # rate 0.4 rows are over budget
    got = sparse_accum(vals, idx, w)
    torch.cuda.synchronize()
    assert torch.equal(got, sparse_accum_ref(vals, idx, w))
    assert torch.equal(got.cpu(), sparse_accum_ref(vals.cpu(), idx.cpu(), w.cpu()))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    s = torch.ones(8, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        spike_matmul(s.t(), torch.ones(8, 2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="int32"):
        spike_matmul(s.to(torch.int64), torch.ones(4, 2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="contiguous int32"):
        sparse_accum(s.t(), s.t(), torch.ones(4, 2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous int32"):
        lif_scan(torch.ones(2, 3, 4, device=cuda), theta_q=1, decay_k=0)


def _net(topology="ff", neuron="lif"):
    return tnet.NetworkConfig(
        layers=(
            tsl.LayerConfig(n_in=64, n_out=32, topology=tsl.Topology(topology),
                            neuron=tsl.NeuronModel(neuron), beta=0.9),
            tsl.LayerConfig(n_in=32, n_out=10, beta=0.77),
        ),
        n_steps=10,
    )


@pytest.mark.parametrize(
    "topology,neuron", [("ff", "lif"), ("ff", "if"), ("ata_t", "lif"), ("ata_f", "synaptic")]
)
def test_backends_on_the_card_match_the_cpu(cuda, topology, neuron):
    net = _net(topology, neuron)
    params = tnet.init_float_params(torch.Generator().manual_seed(1), net, device="cpu")
    q_cpu, _ = tnet.quantize_params(net, params)
    q_gpu = [tsl.IntLayerParams(*(a.to(cuda) for a in p)) for p in q_cpu]
    x = torch.from_numpy(_raster(10 * 16, 64, rate=0.2).reshape(10, 16, 64))
    want = tnet.run_int(net, q_cpu, x)
    for backend in ("reference", "fused", tbe.EventBackend("pallas"), tbe.EventBackend("gather"),
                    "event"):
        got = tnet.run_int(net, q_gpu, x.to(cuda), backend=backend)
        assert torch.equal(got.spike_counts.cpu(), want.spike_counts)
        for a, b in zip(got.layer_spikes, want.layer_spikes):
            assert torch.equal(a.cpu(), b)


def test_engine_on_the_card_matches_the_cpu_engine(cuda):
    net = _net()
    params = tnet.init_float_params(torch.Generator().manual_seed(2), net, device="cpu")
    qparams, _ = tnet.quantize_params(net, params)
    rng = np.random.default_rng(3)
    rasters = [(rng.random((T, 64)) < rate).astype(np.uint8)
               for T, rate in [(10, 0.03), (4, 0.3), (9, 0.05), (7, 0.4), (10, 0.02)]]

    def serve(device):
        engine = SNNServeEngine(net, qparams, max_batch=2, tick_stride=4, device=device,
                                backend=tbe.EventBackend("pallas"))
        engine.warmup()
        done = engine.run([SNNRequest(uid=i, raster=r) for i, r in enumerate(rasters)])
        return {r.uid: r for r in done}

    gpu, cpu = serve(cuda), serve("cpu")
    for uid in range(len(rasters)):
        np.testing.assert_array_equal(gpu[uid].spike_counts, cpu[uid].spike_counts)
        assert gpu[uid].route == cpu[uid].route


def test_streams_on_the_card_match_the_cpu(cuda, tmp_path):
    """Sparse, dense and graded streams, fed group after group with an
    eviction in the middle: the card's readouts, carries and tick modes
    equal the CPU's."""
    net = _net()
    params = tnet.init_float_params(torch.Generator().manual_seed(4), net, device="cpu")
    qparams, _ = tnet.quantize_params(net, params)
    rng = np.random.default_rng(5)
    groups = [
        [(rng.random((24, 64)) < 0.03).astype(np.uint8) for _ in range(3)],
        [(rng.random((24, 64)) < 0.4).astype(np.uint8) for _ in range(3)],
        # graded above this net's f32 certificate (8456): int32 ticks
        [np.where(rng.random((24, 64)) < 0.35, rng.integers(1, 40000, (24, 64)), 0)
         for _ in range(2)],
    ]

    def stream(device):
        engine = SNNServeEngine(net, qparams, max_batch=4, tick_stride=8, device=device,
                                backend=tbe.EventBackend("pallas"))
        manager = StreamSessionManager(
            engine, checkpoint_dir=tmp_path / str(device),
            config=StreamConfig(window=12, stride=8, idle_budget=None),
        )
        out = {}
        for g, rasters in enumerate(groups):
            sids = [manager.open(f"g{g}s{i}").sid for i in range(len(rasters))]
            for lo in range(0, 24, 8):
                for sid, r in zip(sids, rasters):
                    manager.feed(sid, r[lo:lo + 8])
                manager.pump()
                if lo == 8:
                    for sid in sids:
                        manager.evict(sid)
            for sid in sids:
                readouts = [(r.t_end, r.spike_counts.tolist()) for r in manager.drain_readouts(sid)]
                out[sid] = (readouts, manager.sessions[sid].carry)
        ticks = {k: v for k, v in engine.metrics.counters.items() if k.startswith("tick:")}
        return out, ticks

    (gpu, gpu_ticks), (cpu, cpu_ticks) = stream(cuda), stream("cpu")
    assert gpu_ticks == cpu_ticks and set(gpu_ticks) == {"tick:sparse", "tick:f32_exact",
                                                         "tick:int32"}
    for sid, (readouts, carry) in cpu.items():
        assert gpu[sid][0] == readouts and len(readouts) == 3
        for a, b in zip(gpu[sid][1], carry):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_sweep_carries_on_the_card_finds_the_poisoned_slot(cuda):
    """The device-side sweep (one bounds check over the pool, one mask
    copied back) condemns exactly the lane the injector poisoned, as the
    CPU engine's sweep does."""
    net = _net()
    params = tnet.init_float_params(torch.Generator().manual_seed(6), net, device="cpu")
    qparams, _ = tnet.quantize_params(net, params)
    rng = np.random.default_rng(7)
    rasters = [(rng.random((12, 64)) < 0.3).astype(np.uint8) for _ in range(5)]
    for device in (cuda, "cpu"):
        for lane, bit in [(3, 26), (0, 17)]:
            engine = SNNServeEngine(net, qparams, max_batch=6, tick_stride=4, device=device,
                                    faults=FaultInjector().arm("carry", at=1, lane=lane, bit=bit))
            for i, r in enumerate(rasters):
                engine.submit(SNNRequest(uid=i, raster=r))
            engine.poll()
            assert engine.sweep_carries() == []
            engine.poll()  # the second tick's carry fault fires
            assert engine.sweep_carries() == [lane]
            assert engine.quarantine_lane(lane).uid == lane
            assert engine.sweep_carries() == []  # the condemned slot holds no lane


def test_batched_carry_gather_matches_per_lane_take(cuda):
    """``lane_states_take`` (one gather, one copy) equals
    ``lane_state_take`` lane by lane on a pool of random carries."""
    net = _net("ata_t", "synaptic")
    states = tbe.batched_lane_init(net, 16, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    for st in states:
        for a in st:
            a.copy_(torch.randint(-(2**20), 2**20, a.shape, generator=gen, device=cuda,
                                  dtype=torch.int32))
    lanes = [5, 0, 15, 7, 5]
    got = tbe.lane_states_take(states, lanes)
    assert len(got) == len(lanes)
    for lane, snap in zip(lanes, got):
        want = tbe.lane_state_take(states, lane)
        for a, b in zip(snap, want):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
    assert tbe.lane_states_take(states, []) == []


# ---------------------------------------------------------------------------
# LM slice: quant_matmul, flash_attention, the model and the serving engine
# ---------------------------------------------------------------------------

# (bits, M, K, N, dtype): the QM_CASES of tests/test_kernels.py, then ragged
# M / K / N, int4 with N even but not a multiple of the 64-column tile, and
# the full-width decode shapes
QM_CARD_CASES = [
    (8, 256, 1024, 256, torch.bfloat16),
    (8, 128, 512, 128, torch.float32),
    (6, 128, 512, 128, torch.bfloat16),
    (5, 128, 1024, 256, torch.bfloat16),
    (4, 128, 512, 256, torch.bfloat16),
    (4, 256, 1536, 512, torch.bfloat16),
    (8, 5, 96, 24, torch.bfloat16),
    (4, 7, 33, 70, torch.float32),
    (8, 8, 2048, 5632, torch.bfloat16),
    (4, 8, 5632, 2048, torch.bfloat16),
    # split-K edges: K not a multiple of the 64-deep stage or of the split
    # chunk (the last split shorter), a split one stage deep, M at the skinny
    # limit; then unaligned rows (K % 8, N % 16 int8, N % 32 int4) in bf16
    # through the predicated scalar loads, in both regimes
    (8, 8, 1000, 2048, torch.bfloat16),
    (8, 3, 4104, 320, torch.bfloat16),
    (4, 64, 130, 4096, torch.bfloat16),
    (8, 7, 33, 70, torch.bfloat16),
    (4, 7, 33, 70, torch.bfloat16),
    (6, 9, 1030, 998, torch.bfloat16),
    (8, 100, 77, 50, torch.bfloat16),
    (4, 130, 1030, 998, torch.bfloat16),
]


def _qm_tol(dtype):
    # f32 accumulation in another K order than the plain version: up to 2
    # bf16 ulps after the final cast (tests/test_kernels.py), f32 noise else
    return dict(rtol=2**-7 if dtype == torch.bfloat16 else 1e-5, atol=1e-5)


@pytest.mark.parametrize("bits,M,K,N,dtype", QM_CARD_CASES)
def test_quant_matmul_kernel_matches_plain(cuda, bits, M, K, N, dtype):
    from repro_torch.core.precision import quantize_weight
    from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    rng = np.random.default_rng(bits * M + N)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.02).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dtype)
    qt = quantize_weight(w, bits)
    want = quant_matmul_ref(x, qt.q, qt.scale, bits, dtype)  # on the CPU
    n0 = quant_matmul.launches
    got = quant_matmul(x.to(cuda), qt.q.to(cuda), qt.scale.to(cuda), bits=bits)
    torch.cuda.synchronize()
    assert quant_matmul.launches == n0 + 1 and got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), **_qm_tol(dtype))
    out32 = quant_matmul(x.to(cuda), qt.q.to(cuda), qt.scale.to(cuda), bits=bits,
                         out_dtype=torch.float32)
    want32 = quant_matmul_ref(x, qt.q, qt.scale, bits, torch.float32)
    torch.testing.assert_close(out32.cpu(), want32, rtol=1e-5, atol=1e-5)


def _qm_case(bits, M, K, N, seed, dtype=torch.bfloat16):
    from repro_torch.core.precision import quantize_weight

    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.02).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dtype)
    return x, quantize_weight(w, bits)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


@pytest.mark.parametrize(
    "bits,M,K,N", [(8, 8, 2048, 5632), (4, 8, 5632, 2048), (8, 300, 2048, 2048), (4, 300, 1024, 640)]
)
def test_quant_matmul_identical_across_launches(cuda, bits, M, K, N):
    from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul

    x, qt = _qm_case(bits, M, K, N, seed=N)
    args = (x.to(cuda), qt.q.to(cuda), qt.scale.to(cuda))
    first = quant_matmul(*args, bits=bits)
    again = [quant_matmul(*args, bits=bits) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(first), _bits(a)) for a in again)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_rows_independent_at_decode(cuda, bits):
    """Row 3 of a decode call keeps its bits when the other rows change and
    when it is the only row (the split of K depends on K and N alone)."""
    from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul

    M, K, N = 8, 2048, 5632
    x, qt = _qm_case(bits, M, K, N, seed=bits)
    x, q, s = x.to(cuda), qt.q.to(cuda), qt.scale.to(cuda)
    base = quant_matmul(x, q, s, bits=bits)
    other = x.clone()
    other[torch.arange(M, device=cuda) != 3] = torch.randn(M - 1, K, device=cuda).to(x.dtype)
    changed = quant_matmul(other, q, s, bits=bits)
    alone = quant_matmul(x[3:4].contiguous(), q, s, bits=bits)
    torch.cuda.synchronize()
    assert not torch.equal(_bits(base[0]), _bits(changed[0]))
    assert torch.equal(_bits(base[3]), _bits(changed[3]))
    assert torch.equal(_bits(base[3]), _bits(alone[0]))


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_rows_do_not_depend_on_m_in_the_wide_regime(cuda, bits):
    """A 4096-token prefill's first 256 rows equal a 256-token prefill's bit
    for bit (chip_smoke phase 7 needs it of the layer-0 K/V cache)."""
    from repro_torch.kernels.quant_matmul.quant_matmul import plan, quant_matmul

    K, N = 2048, 2048
    x, qt = _qm_case(bits, 4096, K, N, seed=bits + 1)
    x, q, s = x.to(cuda), qt.q.to(cuda), qt.scale.to(cuda)
    full = quant_matmul(x, q, s, bits=bits)
    for M in (256, 65 + 128):
        assert plan(M, K, N).kind == "wide"
        part = quant_matmul(x[:M].contiguous(), q, s, bits=bits)
        torch.cuda.synchronize()
        assert torch.equal(_bits(part), _bits(full[:M]))


@pytest.mark.parametrize("K", [8192, 14336])
def test_quant_matmul_wide_route_at_long_k_within_the_bf16_tolerance(cuda, K):
    """The wide route's longest chains on the main path (jamba's out_proj
    and w_down) at the fixed tolerance of tests/test_kernels.py, unwidened:
    the tensor cores' chain is promoted into f32 sums every few K stages,
    so the error does not grow with K as one long chain's does."""
    from repro_torch.core.precision import quantize_weight
    from repro_torch.kernels.quant_matmul.quant_matmul import plan, quant_matmul
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    M, N = 1024, 4096
    assert plan(M, K, N).kind == "wide"
    gen = torch.Generator(device=cuda).manual_seed(K)
    w = torch.randn(K, N, device=cuda, generator=gen) * K**-0.5
    x = torch.randn(M, K, device=cuda, generator=gen).to(torch.bfloat16)
    qt = quantize_weight(w, 8)
    got = quant_matmul(x, qt.q, qt.scale, bits=8)
    want = quant_matmul_ref(x, qt.q, qt.scale, 8, torch.bfloat16)  # f32 FFMA on the card
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_qm_tol(torch.bfloat16))


def _fa_tol(dtype):
    # the kernel keeps scores, probabilities and the accumulator in f32 like
    # its plain version: bf16 outputs differ by at most one rounding of the
    # final cast (one ulp, <= 2^-7 |want|); the atol, for values near zero,
    # is far below a 4096-key row's typical |output| (~0.02); f32: the same
    # math in another order
    if dtype == torch.bfloat16:
        return dict(rtol=2**-7, atol=2e-3)
    return dict(rtol=1e-4, atol=1e-4)


FA_CARD_CASES = [
    ((2, 4, 4, 512, 512, 64), dict(causal=True)),
    ((1, 2, 2, 1024, 1024, 128), dict(causal=True, window=256)),
    ((1, 2, 2, 512, 512, 64), dict(causal=True, softcap=50.0)),
    ((1, 2, 2, 256, 512, 64), dict(causal=False)),
    ((1, 1, 1, 256, 256, 128), dict(causal=True, window=64, softcap=30.0)),
    ((2, 4, 4, 300, 300, 64), dict(causal=True)),  # ragged Sq = Sk
    ((1, 3, 3, 77, 130, 32), dict(causal=False, window=20)),  # ragged, D < 64
    ((1, 8, 2, 200, 200, 96), dict(causal=True)),  # GQA, D between the kernel's two widths
    # Sq != Sk both ways (queries past Sk see every key), D = 32 / 96 / 128
    ((1, 4, 4, 100, 600, 64), dict(causal=True)),
    ((1, 4, 2, 600, 100, 64), dict(causal=True)),
    ((2, 2, 2, 300, 517, 64), dict(causal=False, window=128)),
    ((1, 2, 2, 333, 333, 32), dict(causal=True)),
    ((1, 2, 1, 257, 257, 96), dict(causal=True, softcap=20.0)),
    ((1, 2, 2, 520, 520, 128), dict(causal=True)),
    # Whisper: the encoder's non-causal self-attention at S = 4096 (16 heads,
    # D = 64) and the decoder's cross-attention, 448 queries on 4096 keys
    ((1, 16, 16, 4096, 4096, 64), dict(causal=False)),
    ((1, 16, 16, 448, 4096, 64), dict(causal=False)),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,kwargs", FA_CARD_CASES)
def test_flash_attention_kernel_matches_plain(cuda, shape, kwargs, dtype):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    B, Hq, Hk, Sq, Sk, D = shape
    rng = np.random.default_rng(Sq + D)
    mk = lambda h, s: torch.from_numpy(rng.standard_normal((B, h, s, D)).astype(np.float32)).to(dtype)
    q, k, v = mk(Hq, Sq), mk(Hk, Sk), mk(Hk, Sk)
    want = flash_attention(q, k, v, **kwargs)  # the CPU: plain version
    n0 = flash_attention.launches
    got = flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), **kwargs)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1 and got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), **_fa_tol(dtype))


def test_flash_attention_identical_across_launches(cuda):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention

    rng = np.random.default_rng(21)
    mk = lambda h: torch.from_numpy(rng.standard_normal((1, h, 1024, 64)).astype(np.float32)).to(
        device=cuda, dtype=torch.bfloat16
    )
    q, k, v = mk(8), mk(2), mk(2)
    for kw in (dict(causal=True), dict(causal=True, window=100, softcap=30.0)):
        first = flash_attention(q, k, v, **kw)
        again = [flash_attention(q, k, v, **kw) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(_bits(first), _bits(a)) for a in again)


def test_flash_attend_gqa_model_layout_matches_attend(cuda):
    from repro_torch.kernels.flash_attention.ops import flash_attend
    from repro_torch.models.attention import AttnMask, attend

    rng = np.random.default_rng(9)
    mk = lambda h: torch.from_numpy(rng.standard_normal((2, 256, h, 64)).astype(np.float32)).to(
        torch.bfloat16
    )
    q, k, v = mk(8), mk(2), mk(2)
    want = attend(q, k, v, mask=AttnMask(causal=True))
    got = flash_attend(q.to(cuda), k.to(cuda), v.to(cuda), causal=True)
    torch.cuda.synchronize()
    assert got.shape == (2, 256, 8, 64) and got.is_contiguous()  # written in model layout
    torch.testing.assert_close(got.cpu().float(), want.float(), **_fa_tol(torch.bfloat16))


def test_lm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul
    from repro_torch.models.attention import attend_chunked

    q8 = torch.ones(16, 8, dtype=torch.int8, device=cuda)
    s = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(torch.ones(16, 3, device=cuda).t(), q8, s)
    with pytest.raises(ValueError, match="bf16/f32"):
        quant_matmul(torch.ones(3, 16, device=cuda, dtype=torch.float16), q8, s)
    with pytest.raises(ValueError, match="int8 q"):
        quant_matmul(torch.ones(3, 16, device=cuda), q8.to(torch.int32), s)
    x = torch.ones(1, 2, 8, 160, device=cuda)
    with pytest.raises(ValueError, match="D <= 128"):
        flash_attention(x, x, x)
    x = torch.ones(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="one bf16/f32 dtype"):
        flash_attention(x, x.to(torch.bfloat16), x)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x, x, torch.ones(1, 2, 16, 8, device=cuda).transpose(2, 3))
    qm = torch.ones(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="positions 0..S-1"):
        attend_chunked(qm, qm, qm, q_positions=torch.arange(3, 11, device=cuda))


def _lm(cuda_dev, compute=torch.float32, bits=8, **overrides):
    import dataclasses

    from repro_torch.core.precision import PrecisionPolicy, QTensor, quantize_tree, tree_map
    from repro_torch.launch.serve import QUANT_RULES
    from repro_torch.models.registry import get_arch

    arch = get_arch("stablelm-1.6b")
    cfg = dataclasses.replace(arch.reduced_config, compute_dtype=compute, **overrides)
    params = arch.init_params(torch.Generator().manual_seed(0), cfg)
    qp = quantize_tree(params, PrecisionPolicy(rules=((QUANT_RULES[0], bits),)))
    qp_gpu = tree_map(lambda _, t: t.to(cuda_dev) if isinstance(t, (torch.Tensor, QTensor)) else t, qp)
    return dataclasses.replace(arch, reduced_config=cfg), cfg, qp, qp_gpu


def test_decode_and_prefill_on_the_card_match_the_cpu(cuda):
    """f32 compute: the card (both kernels) against the CPU (plain
    versions); prefill at S = 4096 goes through attend_chunked -> flash."""
    from repro_torch import kernels
    from repro_torch.models import transformer as tt

    _, cfg, qp, qp_gpu = _lm(cuda)
    tok = torch.tensor([[3], [77]])
    cur = torch.tensor([0, 0], dtype=torch.int32)
    kernels.reset_launch_counts()
    lg, _ = tt.decode_step(cfg, qp_gpu, tt.cache_init(cfg, 2, 8, cuda), tok.to(cuda), cur.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["quant_matmul"] == 7 * cfg.n_layers
    lc, _ = tt.decode_step(cfg, qp, tt.cache_init(cfg, 2, 8, device="cpu"), tok, cur)
    torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4 * float(lc.abs().max()))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 4096)))
    kernels.reset_launch_counts()
    pg, cg = tt.prefill(cfg, qp_gpu, tokens.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    pc, cc = tt.prefill(cfg, qp, tokens)
    torch.testing.assert_close(pg.cpu(), pc, rtol=0, atol=1e-4 * float(pc.abs().max()))
    torch.testing.assert_close(cg["pos0"]["k"].cpu(), cc["pos0"]["k"], rtol=1e-4, atol=1e-4)


def test_lm_serve_engine_on_the_card_matches_the_cpu(cuda):
    from repro_torch.serve.engine import Request, ServeEngine

    arch, _, qp, _ = _lm(cuda)
    prompts = [[1, 2, 3, 4, 5], [7], [8, 9, 10], [1, 2, 3, 4, 5]]

    def serve(device):
        eng = ServeEngine(arch, qp, max_batch=2, max_len=32, device=device)
        done = eng.run([Request(uid=i, prompt=np.array(p), max_new_tokens=6) for i, p in enumerate(prompts)])
        return {r.uid: r.generated for r in done}

    gpu, cpu = serve(cuda), serve("cpu")
    assert gpu == cpu
    assert gpu[0] == gpu[3]


# ---------------------------------------------------------------------------
# The population sweep (candidate axis)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,T,B,N", [(7, 5, 8, 128), (64, 20, 231, 128), (3, 4, 2, 10)])
@pytest.mark.parametrize("zero", [False, True], ids=["subtract", "zero"])
def test_lif_scan_candidate_axis_matches_plain(cuda, P, T, B, N, zero):
    rng = np.random.default_rng(P + T)
    cur = torch.from_numpy(rng.integers(-400, 600, (P, T, B, N)).astype(np.int32)).to(cuda)
    theta = torch.from_numpy(rng.integers(1, 2000, P).astype(np.int32)).to(cuda)
    regs = rng.choice([0, 128, 192, 224, 243, 255, 256, 256 + 5], P).astype(np.int32)
    k = torch.from_numpy(regs).to(cuda)
    n0 = lif_scan.launches
    spk, u = lif_scan(cur, theta_q=theta, decay_k=k, u_bits=16, reset_to_zero=zero)
    torch.cuda.synchronize()
    assert lif_scan.launches == n0 + 1
    spk_ref, u_ref = lif_scan_ref(cur, theta, k, 16, zero)
    assert torch.equal(spk, spk_ref) and torch.equal(u, u_ref)
    s_cpu, u_cpu = lif_scan_ref(cur.cpu(), theta.cpu(), k.cpu(), 16, zero)
    assert torch.equal(spk.cpu(), s_cpu) and torch.equal(u.cpu(), u_cpu)


def test_lif_scan_candidate_axis_refuses_registers_off_the_card(cuda):
    cur = torch.zeros(2, 3, 1, 4, dtype=torch.int32, device=cuda)
    regs = torch.tensor([5, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match="theta_q on cpu"):
        lif_scan(cur, theta_q=regs, decay_k=regs.to(cuda))


@pytest.mark.parametrize("P,T,B,N", [(512, 20, 231, 128), (3, 7, 5, 37)])
@pytest.mark.parametrize("zero", [False, True], ids=["subtract", "zero"])
def test_ataf_scan_matches_plain(cuda, P, T, B, N, zero):
    """The ATA-F scan at the sweep's shape and a ragged one: self-weights
    up to +-2**15 and currents near the int32 limits (both adds wrap),
    per-candidate theta and registers with the bypass among them."""
    rng = np.random.default_rng(P + T + zero)
    gen = torch.Generator(device=cuda).manual_seed(P + T + zero)
    shape = (P, T, B, N)
    band = torch.randint(0, 3, shape, device=cuda, generator=gen)
    cur = torch.randint(-(2**16), 2**16, shape, device=cuda, generator=gen, dtype=torch.int32)
    offsets = torch.tensor([2**31 - 2**16, -(2**31 - 2**16), 0], dtype=torch.int32, device=cuda)
    cur += offsets[band]  # near the int32 maximum, near its minimum, moderate
    del band
    w, theta, k = (torch.from_numpy(a).to(cuda) for a in (
        rng.choice([0, -5, 300, -(2**15), 2**15, 2**15 - 1], P).astype(np.int32),
        rng.integers(1, 30000, P).astype(np.int32),
        rng.choice([0, 128, 192, 243, 255, 256, 256 + 5], P).astype(np.int32),
    ))
    n0 = ataf_scan.launches
    spk = ataf_scan(cur, w_self=w, theta_q=theta, decay_k=k, u_bits=16, reset_to_zero=zero)
    torch.cuda.synchronize()
    assert ataf_scan.launches == n0 + 1 and spk.shape == cur.shape
    assert torch.equal(spk, ataf_scan_ref(cur, w, theta, k, 16, zero))
    assert 0 < int(spk.sum()) < spk.numel()


@pytest.mark.parametrize(
    "topology,neuron", [("ata_f", "lif"), ("ata_f", "if"), ("ata_t", "lif"), ("ata_f", "synaptic"),
                        ("ff", "lif")]
)
def test_population_sweep_launches_one_scan_a_layer(cuda, topology, neuron):
    """Each ``run_int_population`` call launches one ``ataf_scan`` per ATA-F
    IF/LIF layer and one ``lif_scan`` per feed-forward IF/LIF layer, and
    equals the step-major sweep on the card and the sweep on the CPU."""
    net = _net(topology, neuron)
    params = tnet.init_float_params(torch.Generator().manual_seed(3), net, device="cpu")
    cands = [net.replace_precisions(w_bits=w, w_rec_bits=r, leak_bits=l)
             for w, r, l in [(2, 3, 1), (6, 16, 3), (8, 8, 8), (16, 2, 5)]]
    q_cpu = [tnet.quantize_params(c, params)[0] for c in cands]
    q_gpu = [[tsl.IntLayerParams(*(a.to(cuda) for a in p)) for p in q] for q in q_cpu]
    x = torch.from_numpy(_raster(10 * 20, 64, seed=9).reshape(10, 20, 64))
    ataf = sum(c.topology == tsl.Topology.ATA_F and c.neuron != tsl.NeuronModel.SYNAPTIC
               for c in net.layers)
    fused = sum(tsl.fused_eligible(c) for c in net.layers)
    stacked, b, a = tbe.stack_population(cands, q_gpu)
    for _ in range(2):
        n0 = (ataf_scan.launches, lif_scan.launches)
        got = tbe.run_int_population(net, stacked, b, a, x.to(cuda), return_events=True)
        torch.cuda.synchronize()
        assert (ataf_scan.launches - n0[0], lif_scan.launches - n0[1]) == (ataf, fused)
    want = tbe._run_int_dynamic(net, stacked, b, a, x.to(cuda))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    s_cpu, b_cpu, a_cpu = tbe.stack_population(cands, q_cpu)
    cpu = tbe.run_int_population(net, s_cpu, b_cpu, a_cpu, x, return_events=True)
    assert all(torch.equal(g.cpu(), c) for g, c in zip(got, cpu))


@pytest.mark.parametrize("shared", ["s", "w", "none"])
def test_spike_matmul_candidate_axis_matches_plain(cuda, shared):
    """P products in one launch, int8 and 16-bit candidates side by side (the
    tensor cores and the CUDA cores in the same launch)."""
    rng = np.random.default_rng(9)
    P, M, K, N = 6, 20 * 23, 256, 128
    s = (rng.random((P, M, K)) < 0.2).astype(np.int32)
    lims = [2, 32, 128, 2**15, 7, 2**15]
    w = np.stack([rng.integers(-lim, lim, (K, N)) for lim in lims]).astype(np.int32)
    s_t = torch.from_numpy(s[0] if shared == "s" else s).to(cuda)
    w_t = torch.from_numpy(w[0] if shared == "w" else w).to(cuda)
    n0 = spike_matmul.launches
    got = spike_matmul(s_t, w_t)
    torch.cuda.synchronize()
    assert spike_matmul.launches == n0 + 1 and got.shape == (P, M, N)
    assert torch.equal(got, spike_matmul_plain(s_t, w_t))
    for c in range(P):
        want = _wrapped_dense(s[0] if shared == "s" else s[c], w[0] if shared == "w" else w[c])
        np.testing.assert_array_equal(got[c].cpu().numpy(), want)


def _w16(shape, seed, bits=16):
    """Weights of ``bits`` bits with the int16 edges -32768, -129, 128 and
    32767 planted down the first four columns (where ``bits`` reaches them)."""
    lim = 2 ** (bits - 1)
    w = np.random.default_rng(seed).integers(-lim, lim, shape).astype(np.int32)
    for j, v in enumerate([-(2**15), -129, 128, 2**15 - 1][: shape[-1]]):
        if -lim <= v < lim:
            w[..., ::3, j] = v
    return w


def _spikes_fitting_int8(shape, seed):
    """Binary spikes, with the first 16-row strip all -128: against a column
    of -32768 its chunk sums to 2**30, the most the int32 fragment holds."""
    s = (np.random.default_rng(seed).random(shape) < 0.2).astype(np.int32)
    s[..., :16, :] = -128
    return s


@pytest.mark.parametrize("layout", ["single", "shared_s", "per_candidate"])
@pytest.mark.parametrize("N", [10, 128])
@pytest.mark.parametrize("K", [128, 256, 300, 1100])
def test_spike_matmul_int16_weights_match_plain(cuda, K, N, layout):
    """Weights of 9-16 bits times spikes that fit int8 on the two weight
    planes, exact against the int64 product wrapped to int32 at the int16
    edges; K = 1100 leaves no room for the high plane, so there the block
    keeps the CUDA cores."""
    P, M = 3, 1000
    s = _spikes_fitting_int8((M, K) if layout != "per_candidate" else (P, M, K), seed=K)
    w = _w16((K, N) if layout == "single" else (P, K, N), seed=N)
    got = spike_matmul(torch.from_numpy(s).to(cuda), torch.from_numpy(w).to(cuda))
    torch.cuda.synchronize()
    if layout == "single":
        np.testing.assert_array_equal(got.cpu().numpy(), _wrapped_dense(s, w))
        return
    for c in range(P):
        want = _wrapped_dense(s if s.ndim == 2 else s[c], w[c])
        np.testing.assert_array_equal(got[c].cpu().numpy(), want)


@pytest.mark.parametrize("shared", [True, False])
def test_spike_matmul_batch_mixes_weight_widths(cuda, shared):
    """One launch over candidates of 4, 8, 9, 12 and 16 bits and one beyond
    int16, as a sweep mixes widths: the int8 pass, the weight planes and the
    CUDA cores side by side at the sweep's layer-0 shape."""
    bits = [4, 8, 9, 12, 16, 21]
    P, M, K, N = len(bits), 20 * 231, 256, 128
    s = _spikes_fitting_int8((M, K) if shared else (P, M, K), seed=1)
    w = np.stack([_w16((K, N), seed=b, bits=b) for b in bits])
    got = spike_matmul(torch.from_numpy(s).to(cuda), torch.from_numpy(w).to(cuda))
    torch.cuda.synchronize()
    for c in range(P):
        want = _wrapped_dense(s if shared else s[c], w[c])
        np.testing.assert_array_equal(got[c].cpu().numpy(), want)


@pytest.mark.parametrize("batched", [False, True])
def test_spike_matmul_graded_spikes_with_int16_weights(cuda, batched):
    """Graded spikes (128..3999) in a few strips meet 12- and 16-bit weights:
    those strips' chunks take the CUDA cores, the rest the weight planes."""
    M, K, N = 25 * 64, 300, 128
    rng = np.random.default_rng(7)
    s = _raster(M, K, seed=8, rate=0.12)
    for strip in rng.choice(M // 16, 6, replace=False):
        s[16 * strip + rng.integers(0, 16), rng.integers(0, K)] = rng.integers(128, 4000)
    w = np.stack([_w16((K, N), seed=3, bits=12), _w16((K, N), seed=4)])
    s_t, w_t = torch.from_numpy(s).to(cuda), torch.from_numpy(w if batched else w[1]).to(cuda)
    got = spike_matmul(s_t, w_t)
    torch.cuda.synchronize()
    assert torch.equal(got, spike_matmul_plain(s_t, w_t))
    for c, g in enumerate(got if batched else [got]):
        np.testing.assert_array_equal(g.cpu().numpy(), _wrapped_dense(s, w[c if batched else 1]))


@pytest.mark.parametrize("topology,neuron", [("ata_f", "lif"), ("ata_t", "if"), ("ff", "synaptic")])
def test_population_sweep_on_the_card_matches_serial_and_cpu(cuda, topology, neuron):
    from repro_torch.data import snn_datasets as tds
    from repro_torch.snn import train as ttrain

    net = _net(topology, neuron)
    params = tnet.init_float_params(torch.Generator().manual_seed(3), net, device="cpu")
    cands = [net.replace_precisions(w_bits=w, w_rec_bits=r, leak_bits=l)
             for w, r, l in [(2, 3, 1), (6, 16, 3), (8, 8, 8), (16, 2, 5), (12, 6, 2)]]
    q_cpu = [tnet.quantize_params(c, params)[0] for c in cands]
    q_gpu = [[tsl.IntLayerParams(*(a.to(cuda) for a in p)) for p in q] for q in q_cpu]
    ds = tds.mnist_like(n=48, T=10, seed=4)
    ds.spikes = ds.spikes[:, :, :64]
    n0 = (spike_matmul.launches, lif_scan.launches)
    acc_g, st_g = ttrain.eval_int_population(net, cands, q_gpu, ds, batch_size=20, return_stats=True)
    assert spike_matmul.launches > n0[0]
    assert (lif_scan.launches > n0[1]) == any(tsl.fused_eligible(c) for c in net.layers)
    acc_c, st_c = ttrain.eval_int_population(net, cands, q_cpu, ds, batch_size=20, return_stats=True)
    stacked, b_regs, a_regs = tbe.stack_population(cands, q_gpu)
    x = torch.from_numpy(ds.spikes[:20].transpose(1, 0, 2).astype(np.int32)).to(cuda)
    got = tbe.run_int_population(net, stacked, b_regs, a_regs, x, return_events=True)
    want = tbe._run_int_dynamic(net, stacked, b_regs, a_regs, x)  # step-major, on the card
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    np.testing.assert_array_equal(acc_g, acc_c)
    for c, (cand, q) in enumerate(zip(cands, q_gpu)):
        acc, st = ttrain.eval_int(cand, q, ds, batch_size=20, return_stats=True)
        assert acc == acc_g[c]
        for a, b, d in zip(st["layer_events_per_step"], st_g[c]["layer_events_per_step"],
                           st_c[c]["layer_events_per_step"]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, d)


def _tiny_train_net():
    return tnet.NetworkConfig(
        layers=(tsl.LayerConfig(n_in=256, n_out=32, w_bits=6, u_bits=16),
                tsl.LayerConfig(n_in=32, n_out=10, w_bits=6, u_bits=16)),
        n_steps=10, name="train-tiny",
    )


def _to(params, device):
    return [tsl.FloatLayerParams(*(t.to(device) for t in p)) for p in params]


@pytest.mark.parametrize("stacked", [False, True], ids=["one", "candidate-axis"])
def test_qat_forward_on_the_card_matches_the_cpu(cuda, stacked):
    """run_qat on the card == the CPU, bit for bit, one candidate or three on
    a candidate axis; phase A is one spike_matmul launch per layer per step."""
    from repro_torch.snn import qat as tqat
    from repro_torch.snn.surrogate import fast_sigmoid

    net = _tiny_train_net()
    params = tnet.init_float_params(torch.Generator().manual_seed(0), net, device="cpu")
    kw = {}
    if stacked:
        cands = [net.replace_precisions(w_bits=w, leak_bits=k) for w, k in [(2, 3), (3, 8), (9, 1)]]
        names = ("w_maxes", "rec_maxes", "beta_regs", "alpha_regs")
        kw = dict(zip(names, tqat.candidate_grid(cands, "cpu")))
        params = [tsl.FloatLayerParams(*(torch.stack([t] * 3) for t in p)) for p in params]
    x = torch.from_numpy(_raster(10 * 16, 256, seed=2, rate=0.3).reshape(10, 16, 256))
    fn = fast_sigmoid(25.0)
    want = tqat.run_qat(net, params, x, fn, **kw)
    n0 = spike_matmul.launches
    got = tqat.run_qat(net, _to(params, cuda), x.to(cuda), fn,
                       **{k: v.to(cuda) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert spike_matmul.launches - n0 == 10 * len(net.layers)
    assert torch.equal(got.spike_counts.cpu(), want.spike_counts)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got.layer_spikes, want.layer_spikes))
    assert int(want.layer_spikes[0].sum()) > 0


@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
def test_one_train_step_on_the_card_matches_the_cpu(cuda, qat):
    """train_snn on one batch (one AdamW step) from the same parameters, held
    stage by stage: the loss within 1e-5 relative, every gradient leaf (read
    where train_snn clips it) within 1e-5 of its max |grad|, and the AdamW
    update from the same gradients within 1e-5 of each leaf's max |w|.  The
    composed step's parameters are not held to 1e-5: AdamW's first update
    g / (|g| + eps) amplifies float noise in an element whose |g| is near
    eps = 1e-8 by up to 1 / eps (chip_smoke.py on an H100: 3.5e-5 of max
    |w|, at elements with |g| of 1.9e-9 to 9.9e-8); they must stay within
    one step, lr."""
    from unittest import mock

    from repro_torch.data import snn_datasets as tds
    from repro_torch.snn import qat as tqat
    from repro_torch.snn import train as ttrain
    from repro_torch.train import optimizer as topt

    net = _tiny_train_net()
    ds = tds.mnist_like(n=64, T=10, seed=11)
    params = tnet.init_float_params(torch.Generator().manual_seed(0), net, device="cpu")
    kw = dict(epochs=1, batch_size=64, lr=2e-3,
              qat=tqat.PrecisionConfig(w_bits=3) if qat else None)
    seen, real = [], topt.clip_by_global_norm

    def spy(grads, max_norm, batch_dims=0):
        out = real(grads, max_norm, batch_dims)
        seen.append(([g.cpu() for g in grads], [g.cpu() for g in out[0]]))
        return out

    with mock.patch.object(topt, "clip_by_global_norm", spy):
        got = ttrain.train_snn(net, ds, init_params=_to(params, cuda), device=cuda, **kw)
        want = ttrain.train_snn(net, ds, init_params=params, device="cpu", **kw)
    lw, lg = want.history[0]["loss"], got.history[0]["loss"]
    assert abs(lg - lw) <= 1e-5 * abs(lw)
    (g_card, _), (g_cpu, clipped) = seen
    for a, b in zip(g_card, g_cpu):
        if b.numel():
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    leaves = [t for p in params for t in p]
    updated = []
    for dev in ("cpu", cuda):
        opt = topt.adamw(topt.linear_warmup_cosine(2e-3, 1, 1))
        ps = [t.to(dev) for t in leaves]
        upd, _ = opt.update([g.to(dev) for g in clipped], opt.init(ps), ps)
        updated.append([(p + u).cpu() for p, u in zip(ps, upd)])
    for a, b in zip(*updated):
        if b.numel():
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for a, b in zip(got.params, want.params):
        for x, y in zip(a, b):
            assert x.device.type == "cuda"
            if y.numel():
                assert float((x.cpu() - y).abs().max()) <= 2e-3
    with pytest.raises(ValueError, match="init_params are on cpu"):
        ttrain.train_snn(net, ds, init_params=params, **kw)


def _card_mesh(cuda, n=4):
    from repro_torch.core import shard

    return shard.make_mesh(n, devices=[torch.device("cuda", 0)] * n)


def _launches():
    return {"spike_matmul": spike_matmul.launches, "lif_scan": lif_scan.launches,
            "ataf_scan": ataf_scan.launches, "sparse_accum": sparse_accum.launches}


def _delta(before):
    return {k: v - before[k] for k, v in _launches().items()}


@pytest.mark.parametrize("backend", ["fused", "event"])
def test_sharded_eval_int_on_the_card_matches_serial(cuda, backend):
    """Four shards on one card (the strided sample-axis slices must reach
    the kernels contiguous): accuracy and statistics equal the serial run,
    and a batch that divides launches each kernel n_shards times the serial
    run's at the shard's size."""
    from repro_torch.core import shard
    from repro_torch.data import snn_datasets as tds
    from repro_torch.snn import train as ttrain

    net = _net()
    params = tnet.init_float_params(torch.Generator().manual_seed(5), net, device="cpu")
    qp = [tsl.IntLayerParams(*(a.to(cuda) for a in p)) for p in tnet.quantize_params(net, params)[0]]
    ds = tds.mnist_like(n=50, T=10, seed=6, max_rate=0.15)
    ds.spikes = ds.spikes[:, :, :64]
    mesh = _card_mesh(cuda)
    resolved = tbe.get_backend(backend)
    want = ttrain.eval_int(net, qp, ds, batch_size=24, return_stats=True, backend=resolved)
    got = ttrain.eval_int(net, qp, ds, batch_size=24, return_stats=True, backend=resolved, mesh=mesh)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1]["input_events_per_step"], want[1]["input_events_per_step"])
    for a, b in zip(got[1]["layer_events_per_step"], want[1]["layer_events_per_step"]):
        np.testing.assert_array_equal(a, b)
    x = torch.from_numpy(ds.spikes[:24].transpose(1, 0, 2).astype(np.int32)).to(cuda)
    surrogate = resolved.jit_surrogate(net, x) or resolved
    before = _launches()
    rec = shard.run_int_sharded(net, qp, x, mesh, backend=resolved)
    torch.cuda.synchronize()
    sharded = _delta(before)
    before = _launches()
    serial = surrogate.run_int(net, qp, x[:, :6].contiguous())
    torch.cuda.synchronize()
    one = _delta(before)
    assert sharded == {k: 4 * v for k, v in one.items()} and sum(one.values()) > 0
    assert torch.equal(rec.spike_counts[:6], serial.spike_counts)


def test_sharded_sweep_on_the_card_matches_serial(cuda):
    """Five candidates on four shards of one card: edge-padded (theta and
    registers too, which lif_scan reads on the device), sliced back, equal
    to the one-device sweep; n_shards x its launches at P = 2."""
    from repro_torch.core import shard

    net = _net()
    params = tnet.init_float_params(torch.Generator().manual_seed(3), net, device="cpu")
    cands = [net.replace_precisions(w_bits=w, leak_bits=l)
             for w, l in [(2, 1), (6, 3), (8, 8), (16, 5), (12, 2)]]
    qs = [[tsl.IntLayerParams(*(a.to(cuda) for a in p)) for p in tnet.quantize_params(c, params)[0]]
          for c in cands]
    stacked, b, a = tbe.stack_population(cands, qs)
    x = torch.from_numpy(_raster(10 * 20, 64, seed=9).reshape(10, 20, 64)).to(cuda)
    want = tbe.run_int_population(net, stacked, b, a, x, return_events=True)
    before = _launches()
    got = shard.run_int_population_sharded(net, stacked, b, a, x, _card_mesh(cuda), return_events=True)
    torch.cuda.synchronize()
    sharded = _delta(before)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    two = [[t[:2] for t in p] for p in stacked]
    before = _launches()
    tbe.run_int_population(net, [tsl.IntLayerParams(*p) for p in two], b[:2], a[:2], x)
    torch.cuda.synchronize()
    one = _delta(before)
    assert sharded == {k: 4 * v for k, v in one.items()} and one["lif_scan"] > 0


def test_sharded_engine_on_the_card_matches_serial(cuda):
    """A four-shard lane pool on one card serves every request equal to a
    serial run_int.  Admission and each tick's route are global decisions,
    so it runs the unsharded engine's ticks, and every tick that launches a
    kernel launches it on every shard: four times the unsharded launches."""
    net = _net()
    params = tnet.init_float_params(torch.Generator().manual_seed(2), net, device="cpu")
    qp = [tsl.IntLayerParams(*(a.to(cuda) for a in p)) for p in tnet.quantize_params(net, params)[0]]
    rng = np.random.default_rng(1)
    rasters = [(rng.random((int(rng.integers(3, 11)), 64)) < r).astype(np.uint8)
               for r in [0.03] * 8 + [0.3] * 8]
    # values above the f32 certificate (2**24 / (31 * 64) for w6): an int32 tick
    rasters += [np.where(rng.random((6, 64)) < 0.3, 20000, 0).astype(np.int32)]
    runs = {}
    for dp in (None, _card_mesh(cuda)):
        eng = SNNServeEngine(net, qp, max_batch=8, data_parallel=dp, device=cuda,
                             backend=tbe.EventBackend("pallas"))
        before = _launches()
        done = eng.run([SNNRequest(uid=i, raster=r) for i, r in enumerate(rasters)])
        torch.cuda.synchronize()
        ticks = {k: v for k, v in eng.metrics.counters.items() if k.startswith("tick:")}
        runs[eng.data_parallel] = (_delta(before), ticks, {r.uid: r.spike_counts for r in done})
    (one, ticks1, res1), (four, ticks4, res4) = runs[1], runs[4]
    assert ticks4 == ticks1 and ticks1.get("tick:sparse") and ticks1.get("tick:int32")
    assert four == {k: 4 * v for k, v in one.items()} and one["spike_matmul"] > 0
    for uid, r in enumerate(rasters):
        x = torch.from_numpy(r.astype(np.int32)[:, None, :]).to(cuda)
        want = tnet.run_int(net, qp, x).spike_counts[0].cpu().numpy()
        assert np.array_equal(res4[uid], want) and np.array_equal(res1[uid], want)


# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "name",
    ["stablelm-1.6b", "qwen2-moe-a2.7b", "mamba2-780m", "jamba-v0.1-52b", "qwen2-vl-2b", "whisper-medium"],
)
def test_one_lm_train_step_on_the_card_matches_the_cpu(cuda, name):
    """build_train_step at f32 compute (qwen2-moe: shared experts; qwen2-vl:
    the input template's patch embeddings and positions; whisper: audio
    frames, encoder and decoder) from the
    same parameters and batch, held stage by stage: the loss within 1e-5
    relative, every gradient leaf (read where the step clips them) within
    1e-5 of its max |g|, and the AdamW update from the same gradients
    within 1e-5 of each leaf's max |w|.  Configs with SSD blocks hold the
    gradients to 1e-4, the port-vs-JAX limit of test_torch_lm_train.py:
    the SSD's exp of chunk-cumsum differences spreads f32 reordering past
    1e-5 of max |g| between two orders (the reduced jamba card vs CPU on
    an H100: 3.9e-5).  For them the witness is the same step on the CPU
    with every float32 run as float64: the card's f32 gradients may lie no
    more than 4x as far from it as the CPU's f32 gradients do."""
    import dataclasses
    from unittest import mock

    from repro_torch.core.precision import tree_map
    from repro_torch.launch import steps
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.registry import ShapeSpec, get_arch
    from repro_torch.train import optimizer as topt

    arch = get_arch(name)
    cfg = dataclasses.replace(arch.reduced_config, compute_dtype=torch.float32)
    shape = ShapeSpec("t", 32, 4, "train")
    params = arch.init_params(torch.Generator().manual_seed(0), cfg)
    batch = arch.input_concrete(torch.Generator().manual_seed(1), shape, cfg)
    seen, real = [], topt.clip_by_global_norm

    def spy(grads, max_norm, batch_dims=0):
        seen.append([g.cpu() for g in grads])
        return real(grads, max_norm, batch_dims)

    def run(dev):
        p = tree_map(lambda _, t: t.to(dev, copy=True), params)
        opt = topt.adamw(3e-4)
        st = opt.init([t for _, t in tree_leaves(p)])
        step = steps.build_train_step(arch, shape, None, cfg, optimizer=opt).jitted
        return step(p, st, {k: v.to(dev) for k, v in batch.items()})[2]["loss"]

    with mock.patch.object(topt, "clip_by_global_norm", spy):
        lg, lc = float(run(cuda)), float(run("cpu"))
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    g_card, g_cpu = seen
    ssm = getattr(cfg, "ssm", None) is not None
    g_tol = 1e-4 if ssm else 1e-5
    for a, b in zip(g_card, g_cpu):
        assert float((a - b).abs().max()) <= g_tol * float(b.abs().max())
    if ssm:
        f64 = torch.float64
        p = tree_map(lambda _, t: t.to(f64, copy=True), params)
        opt = topt.adamw(3e-4)
        c64 = dataclasses.replace(cfg, compute_dtype=f64)
        step = steps.build_train_step(arch, shape, None, c64, optimizer=opt).jitted
        with mock.patch.object(topt, "clip_by_global_norm", spy), \
                mock.patch.object(torch, "float32", f64):
            step(p, opt.init([t for _, t in tree_leaves(p)]), batch)
        g64 = seen[2]
        assert all(g.dtype == f64 for g in g64)
        worst = [
            max(float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for a, w in zip(g, g64))
            for g in (g_card, g_cpu)
        ]
        assert worst[0] <= 4 * worst[1], worst
    clipped, _ = real(g_cpu, 1.0)
    leaves = [t for _, t in tree_leaves(params)]
    updated = []
    for dev in ("cpu", cuda):
        opt = topt.adamw(3e-4)
        ps = [t.to(dev) for t in leaves]
        upd, _ = opt.update([g.to(dev) for g in clipped], opt.init(ps), ps)
        updated.append([(p + u).cpu() for p, u in zip(ps, upd)])
    for a, b in zip(*updated):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_flash_attend_refuses_inputs_that_require_grad_on_the_card(cuda):
    from repro_torch.kernels.flash_attention.ops import flash_attend

    q = torch.randn(1, 128, 2, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attend(q, k, k)
    with torch.no_grad():
        assert flash_attend(q, k, k).shape == q.shape


def test_moe_routing_on_the_card_matches_the_cpu(cuda):
    """The same router logits routed on both devices: the same experts for
    every token and ties kept on the lower expert (torch.topk promises no
    tie order on the card; the port sorts stably)."""
    from repro_torch.models import mlp
    from repro_torch.models.registry import get_arch

    cfg = get_arch("granite-moe-1b-a400m").config.moe  # 32 experts, top 8
    logits = torch.randn(4, 256, cfg.n_experts, generator=torch.Generator().manual_seed(0))
    logits[0, :16] = 0.0  # all tied
    logits[1, :16] = 0.0
    logits[1, :16, ::2] = 1.0  # 16 tied for 8 places
    gc, auxc = mlp._route(cfg, logits)
    gg, auxg = mlp._route(cfg, logits.to(cuda))
    assert torch.equal(gg.cpu() > 0, gc > 0)
    assert (gc[0, :16] > 0).nonzero()[:, 1].reshape(16, 8).tolist() == [list(range(8))] * 16
    assert (gc[1, :16] > 0).nonzero()[:, 1].reshape(16, 8).tolist() == [list(range(0, 16, 2))] * 16
    torch.testing.assert_close(gg.cpu(), gc, rtol=1e-6, atol=1e-7)
    assert abs(float(auxg) - float(auxc)) <= 1e-6 * float(auxc)


# ---------------------------------------------------------------------------
# SSM, hybrid and VLM LMs
# ---------------------------------------------------------------------------


def _family(cuda_dev, name, bits=8):
    """A reduced config at f32 compute, int8 block weights on the CPU and on the card."""
    import dataclasses

    from repro_torch.core.precision import PrecisionPolicy, QTensor, quantize_tree, tree_map
    from repro_torch.launch.serve import QUANT_RULES
    from repro_torch.models.registry import get_arch

    arch = get_arch(name)
    cfg = dataclasses.replace(arch.reduced_config, compute_dtype=torch.float32)
    params = arch.init_params(torch.Generator().manual_seed(0), cfg)
    qp = quantize_tree(params, PrecisionPolicy(rules=((QUANT_RULES[0], bits),)))
    qp_gpu = tree_map(lambda _, t: t.to(cuda_dev) if isinstance(t, (torch.Tensor, QTensor)) else t, qp)
    return dataclasses.replace(arch, reduced_config=cfg), cfg, qp, qp_gpu


def _caches_close(got, want):
    for pos, c in want.items():
        for name, w in c.items():
            g = got[pos][name].cpu()
            assert g.dtype == w.dtype, (pos, name)
            torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=1e-4 * max(1.0, float(w.float().abs().max())))


@pytest.mark.parametrize("name", ["mamba2-780m", "jamba-v0.1-52b", "qwen2-vl-2b"])
def test_family_decode_and_prefill_on_the_card_match_the_cpu(cuda, name):
    """Three decode steps (SSM caches written in place on the card) and a
    4096-token prefill (jamba: one flash launch; qwen2-vl: 256 patch
    embeddings, two), card (kernels) against CPU (plain) at f32 compute:
    logits within 1e-4 of max |logit|, every cache leaf within 1e-4."""
    from repro_torch import kernels
    from repro_torch.models import transformer as tt

    arch, cfg, qp, qp_gpu = _family(cuda, name)
    cg, cc = tt.cache_init(cfg, 2, 8, cuda), tt.cache_init(cfg, 2, 8, device="cpu")
    cur = torch.tensor([0, 3], dtype=torch.int32)
    for t in ([3, 77], [5, 1], [9, 400]):
        tok = torch.tensor(t)[:, None]
        lg, _ = tt.decode_step(cfg, qp_gpu, cg, tok.to(cuda), cur.to(cuda))
        lc, _ = tt.decode_step(cfg, qp, cc, tok, cur)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4 * float(lc.abs().max()))
        cur += 1
    _caches_close(cg, cc)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (1, 4096)))}
    if arch.family == "vlm":
        batch["tokens"] = batch["tokens"][:, 256:]
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal((1, 256, cfg.d_model)).astype(np.float32))
    kernels.reset_launch_counts()
    pg, kg = arch.prefill_fn(cfg)(qp_gpu, {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    n_attn = sum(k.mixer == "attn" for k in tt.layer_pattern(cfg)) * tt.n_groups(cfg)
    assert kernels.launch_counts()["flash_attention"] == n_attn
    pc, kc = arch.prefill_fn(cfg)(qp, batch)
    torch.testing.assert_close(pg.cpu(), pc, rtol=0, atol=1e-4 * float(pc.abs().max()))
    _caches_close(kg, kc)


def test_whisper_prefill_and_decode_on_the_card_match_the_cpu(cuda):
    """whisper-medium reduced, f32 compute, int8 block weights: a prefill of
    2 clips x 4096 frames (the encoder's 2 non-causal flash_attention
    launches on the card) and 4 greedy decode steps (self caches appended
    in place), card (kernels) against CPU (plain): the caches within 1e-4
    of each leaf's max |value|, the logits within 1e-4 of max |logit|."""
    from repro_torch import kernels

    arch, cfg, qp, qp_gpu = _family(cuda, "whisper-medium")
    frames = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4096, cfg.d_model)).astype(np.float32))
    kernels.reset_launch_counts()
    cg = arch.prefill_fn(cfg)(qp_gpu, {"audio_frames": frames.to(cuda)})
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == cfg.n_enc_layers
    cc = arch.prefill_fn(cfg)(qp, {"audio_frames": frames})
    _caches_close(cg, cc)
    tok, cur = torch.tensor([[0], [7]], dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    for _ in range(4):
        lg, cg = arch.decode_fn(cfg)(qp_gpu, cg, {"tokens": tok.to(cuda), "cur_len": cur.to(cuda)})
        lc, cc = arch.decode_fn(cfg)(qp, cc, {"tokens": tok, "cur_len": cur})
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4 * float(lc.abs().max()))
        tok, cur = lc.argmax(-1).to(torch.int32), cur + 1
    _caches_close(cg, cc)


def test_ssm_serve_engine_on_the_card_matches_the_cpu(cuda):
    from repro_torch.serve.engine import Request, ServeEngine

    arch, _, qp, _ = _family(cuda, "mamba2-780m")
    prompts = [[1, 2, 3, 4, 5], [7], [8, 9, 10], [1, 2, 3, 4, 5]]

    def serve(device):
        eng = ServeEngine(arch, qp, max_batch=2, max_len=32, device=device)
        done = eng.run([Request(uid=i, prompt=np.array(p), max_new_tokens=6) for i, p in enumerate(prompts)])
        return {r.uid: r.generated for r in done}

    gpu, cpu = serve(cuda), serve("cpu")
    assert gpu == cpu
    assert gpu[0] == gpu[3]
