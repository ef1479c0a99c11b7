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
from repro_torch.kernels.lif_scan.lif_scan import lif_scan
from repro_torch.kernels.lif_scan.ref import lif_scan_ref
from repro_torch.kernels.quant_matmul.spike_matmul import spike_matmul, spike_matmul_plain
from repro_torch.kernels.sparse_accum.ops import fixed_capacity_events
from repro_torch.kernels.sparse_accum.ref import sparse_accum_ref
from repro_torch.kernels.sparse_accum.sparse_accum import sparse_accum
from repro_torch.serve.snn_engine import SNNRequest, SNNServeEngine

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


@pytest.mark.parametrize("T,B,N,theta,k,u_bits,zero", LIF_CASES)
def test_lif_scan_kernel_matches_plain(cuda, T, B, N, theta, k, u_bits, zero):
    cur = np.random.default_rng(T * N + k).integers(-300, 400, (T, B, N)).astype(np.int32)
    cur_t = torch.from_numpy(cur)
    s1, u1 = lif_scan(cur_t.to(cuda), theta_q=theta, decay_k=k, u_bits=u_bits, reset_to_zero=zero)
    s2, u2 = lif_scan_ref(cur_t, theta, k, u_bits, zero)
    torch.cuda.synchronize()
    assert torch.equal(s1.cpu(), s2) and torch.equal(u1.cpu(), u2)


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
