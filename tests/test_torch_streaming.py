"""The port's streaming sessions: any chunking of a stream == the unchunked run.

``tests/test_streaming_props.py``'s seam-exactness battery re-pointed at
``repro_torch.serve.streaming`` on the CPU: every chunk schedule of a stream
gives sliding-window readouts equal to the prefix-count oracle of a serial
``run_int`` (the port's ``reference``, itself equal to JAX's in
``test_torch_backend.py``), for every neuron x topology x reset combination;
evict -> restore -> continue equals never evicted; interleaved sessions on
fewer lanes do not leak carries; lifecycle errors and conservation; and the
hypothesis case over random cut sets.  Beside them, the same streams through
JAX's and the port's ``StreamSessionManager`` give identical readouts and
summaries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jnet
from repro.core import snn_layer as jsl
from repro.serve import snn_engine as jeng
from repro.serve import streaming as jstream
from repro_torch.core import network as tnet
from repro_torch.core import snn_layer as tsl
from repro_torch.serve.snn_engine import SNNServeEngine
from repro_torch.serve.streaming import (
    SessionClosedError,
    StreamConfig,
    StreamOverflowError,
    StreamSessionManager,
    UnknownSessionError,
)

COMBOS = [
    pytest.param("ff", "lif", "subtract", id="ff-lif-sub"),
    pytest.param("ff", "if", "zero", id="ff-if-zero"),
    pytest.param("ff", "synaptic", "subtract", id="ff-syn-sub"),
    pytest.param("ata_f", "lif", "zero", id="ataf-lif-zero"),
    pytest.param("ata_t", "lif", "subtract", id="atat-lif-sub"),
    pytest.param("ata_t", "synaptic", "zero", id="atat-syn-zero"),
]


def _net(topology, neuron, reset, n_in=18, T=8, sl=tsl, nw=tnet):
    return nw.NetworkConfig(
        layers=(
            sl.LayerConfig(n_in=n_in, n_out=10, neuron=sl.NeuronModel(neuron),
                           topology=sl.Topology(topology), reset=sl.ResetMode(reset), beta=0.9),
            sl.LayerConfig(n_in=10, n_out=4, neuron=sl.NeuronModel(neuron),
                           reset=sl.ResetMode(reset), beta=0.77),
        ),
        n_steps=T,
    )


def _float_arrays(net, seed):
    """Float parameters from a numpy seed (uniform(+-1/sqrt(fan_in)) weights)."""
    rng = np.random.default_rng(seed)
    arrays = []
    for cfg in net.layers:
        lim = 1 / np.sqrt(cfg.n_in)
        w_ff = rng.uniform(-lim, lim, (cfg.n_in, cfg.n_out)).astype(np.float32)
        if cfg.topology.value == "ata_t":
            w_rec = rng.uniform(-0.3, 0.3, (cfg.n_out, cfg.n_out)).astype(np.float32)
        elif cfg.topology.value == "ata_f":
            w_rec = np.float32(0.1)
        else:
            w_rec = np.zeros(0, np.float32)
        arrays.append((w_ff, w_rec, np.float32(cfg.threshold)))
    return arrays


def _quantized(net, seed=0):
    params = tnet.float_params_from_numpy(net, _float_arrays(net, seed), device="cpu")
    return tnet.quantize_params(net, params)[0]


def _raster(net, T, seed=1, rate=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((T, net.n_in)) < rate).astype(np.int64)


def _prefix_counts(net, qparams, raster, b, cache={}):
    """Serial oracle: run_int on the first b steps == cumulative counts.

    Cached by content -- the network config and the quantized arrays'
    shapes and bytes -- never by ``id(qparams)``: a freed ``qparams``'s id
    is reused by the next combo's, which would read the earlier net's
    counts."""
    arrays = tuple((tuple(t.shape), t.numpy().tobytes()) for p in qparams for t in p)
    key = (net, arrays, raster.tobytes(), b)
    if key not in cache:
        if b == 0:
            cache[key] = np.zeros(net.n_classes, np.int64)
        else:
            x = torch.from_numpy(raster[:b, None, :].astype(np.int32))
            cache[key] = tnet.run_int(net, qparams, x).spike_counts[0].numpy().astype(np.int64)
    return cache[key]


def _manager(net, qparams, ckpt=None, window=12, stride=5, max_batch=3, **cfg):
    engine = SNNServeEngine(net, qparams, max_batch=max_batch, tick_stride=8, device="cpu")
    return StreamSessionManager(
        engine,
        checkpoint_dir=ckpt,
        config=StreamConfig(window=window, stride=stride, idle_budget=None, **cfg),
    )


def _run_chunked(mgr, sid, raster, edges, evict_after=()):
    """Feed raster[edges[i]:edges[i+1]] chunk by chunk; evict (and let the
    next feed restore) after the chunk indices in ``evict_after``."""
    s = mgr.sessions.get(sid) or mgr.open(sid)
    for i in range(len(edges) - 1):
        mgr.feed(sid, raster[edges[i]:edges[i + 1]])
        mgr.pump()
        if i in evict_after:
            mgr.evict(sid)
            assert s.state == "evicted"
    return mgr.drain_readouts(sid), s


def _assert_readouts_serial(net, qparams, raster, readouts, window, stride, T):
    assert [r.t_end for r in readouts] == list(range(stride, T + 1, stride))
    for r in readouts:
        start = max(0, r.t_end - window)
        want = _prefix_counts(net, qparams, raster, r.t_end) - _prefix_counts(
            net, qparams, raster, start
        )
        np.testing.assert_array_equal(r.spike_counts, want)
        assert r.window == r.t_end - start
        assert r.prediction == int(np.argmax(want))


@pytest.mark.parametrize("topology,neuron,reset", COMBOS)
def test_chunked_matches_serial_every_combo(topology, neuron, reset):
    """1-step chunks, pow2-straddling chunks, ragged chunks: all schedules
    of the same stream produce identical, serial-exact readouts."""
    net = _net(topology, neuron, reset)
    qparams = _quantized(net)
    T = 26
    raster = _raster(net, T)
    window, stride = 12, 5
    schedules = [
        [0, T],  # one shot
        list(range(T + 1)),  # 1-step chunks: the worst case
        [0, 3, 4, 11, 16, 17, 26],  # ragged, crossing pow2 boundaries
        [0, 7, 9, 26],  # chunk > tick_stride cap: split across ticks
    ]
    results = []
    for edges in schedules:
        mgr = _manager(net, qparams, window=window, stride=stride)
        readouts, _ = _run_chunked(mgr, "s", raster, edges)
        _assert_readouts_serial(net, qparams, raster, readouts, window, stride, T)
        results.append([r.spike_counts for r in readouts])
    for other in results[1:]:
        for a, b in zip(results[0], other):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("topology,neuron,reset", [COMBOS[2], COMBOS[4]])
def test_evict_restore_continue_matches_never_evicted(topology, neuron, reset, tmp_path):
    """checkpoint -> evict -> restore -> continue == never evicted."""
    net = _net(topology, neuron, reset)
    qparams = _quantized(net)
    T = 24
    raster = _raster(net, T, seed=5)
    edges = [0, 5, 9, 14, 20, 24]

    base, _ = _run_chunked(_manager(net, qparams), "s", raster, edges)
    mgr_evict = _manager(net, qparams, ckpt=tmp_path / "ck")
    churned, s = _run_chunked(mgr_evict, "s", raster, edges, evict_after={0, 2, 3})
    assert s.n_evictions == 3 and s.n_restores == 3

    assert [r.t_end for r in churned] == [r.t_end for r in base]
    for a, b in zip(churned, base):
        np.testing.assert_array_equal(a.spike_counts, b.spike_counts)
    _assert_readouts_serial(net, qparams, raster, churned, 12, 5, T)


def test_concurrent_sessions_no_carry_cross_talk():
    """Interleaved sessions with different inputs each stay serial-exact:
    lane reassignment between chunks never leaks one stream's carry into
    another."""
    net = _net("ata_t", "synaptic", "subtract")
    qparams = _quantized(net)
    T = 20
    rasters = {f"s{i}": _raster(net, T, seed=10 + i) for i in range(4)}
    mgr = _manager(net, qparams, max_batch=2)  # fewer lanes than sessions
    for sid in rasters:
        mgr.open(sid)
    edges = [0, 3, 8, 9, 15, 20]
    for i in range(len(edges) - 1):
        for sid in rasters:  # interleave: every session feeds every round
            mgr.feed(sid, rasters[sid][edges[i]:edges[i + 1]])
        mgr.pump()
    for sid, raster in rasters.items():
        _assert_readouts_serial(net, qparams, raster, mgr.drain_readouts(sid), 12, 5, T)


def test_lifecycle_errors_and_conservation():
    net = _net("ff", "lif", "subtract")
    mgr = _manager(net, _quantized(net))
    raster = _raster(net, 8)

    with pytest.raises(UnknownSessionError):
        mgr.feed("ghost", raster)
    with pytest.raises(UnknownSessionError):
        mgr.close("ghost")

    s = mgr.open("a", max_pending_steps=4)
    with pytest.raises(StreamOverflowError):
        mgr.feed("a", raster)  # 8 > 4: refused atomically
    assert s.pending_steps == 0
    mgr.feed("a", raster[:3])
    mgr.pump()
    assert mgr.close("a")["state"] == "closed"
    with pytest.raises(SessionClosedError):
        mgr.feed("a", raster[:1])
    with pytest.raises(SessionClosedError):
        mgr.close("a")
    assert mgr.conservation() == {"opened": 1, "live": 0, "evicted": 0, "closed": 1}

    with pytest.raises(ValueError):
        StreamConfig(window=0)
    with pytest.raises(ValueError):
        StreamConfig(stride=0)
    with pytest.raises(ValueError):
        mgr.open("b", window=-1)


def test_streams_equal_jax_session_manager(tmp_path):
    """The same streams, chunk schedules and evictions through JAX's and the
    port's session managers: identical readouts, summaries and carries."""
    tn = _net("ata_t", "synaptic", "subtract")
    jn = _net("ata_t", "synaptic", "subtract", sl=jsl, nw=jnet)
    tq = _quantized(tn)
    jq = [jsl.IntLayerParams(*(jnp.asarray(a.numpy()) for a in p)) for p in tq]
    cfg = dict(window=9, stride=4, idle_budget=None)
    tm = StreamSessionManager(
        SNNServeEngine(tn, tq, max_batch=2, tick_stride=4, device="cpu"),
        checkpoint_dir=tmp_path / "t", config=StreamConfig(**cfg),
    )
    jm = jstream.StreamSessionManager(
        jeng.SNNServeEngine(jn, jq, max_batch=2, tick_stride=4),
        checkpoint_dir=tmp_path / "j", config=jstream.StreamConfig(**cfg),
    )
    rasters = {f"s{i}": _raster(tn, 19, seed=30 + i) for i in range(3)}
    edges = [0, 2, 7, 8, 13, 19]
    for m in (tm, jm):
        for sid in rasters:
            m.open(sid)
        for i in range(len(edges) - 1):
            for sid, r in rasters.items():
                m.feed(sid, r[edges[i]:edges[i + 1]])
            m.pump()
            if i == 1:
                for sid in rasters:
                    m.evict(sid)
    for sid in rasters:
        got, want = tm.drain_readouts(sid), jm.drain_readouts(sid)
        assert [r.t_end for r in got] == [r.t_end for r in want] == list(range(4, 20, 4))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.spike_counts, b.spike_counts)
            assert (a.window, a.prediction) == (b.window, b.prediction)
        for a, b in zip(tm.sessions[sid].carry, jm.sessions[sid].carry):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, np.asarray(y))
        assert tm.close(sid) == jm.close(sid)
    assert tm.conservation() == jm.conservation()


# ---------------------------------------------------------------------------
# hypothesis: random chunk schedules (only this test skips when the
# dependency is absent -- the deterministic battery above always runs)
# ---------------------------------------------------------------------------

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # hypothesis is a CI-only dependency (requirements-dev)
    HAVE_HYPOTHESIS = False

_T_H = 22

if HAVE_HYPOTHESIS:
    _NET_H = _net("ata_t", "synaptic", "subtract")
    _QPARAMS_H = _quantized(_NET_H)
    _RASTER_H = _raster(_NET_H, _T_H, seed=42)
    _MGRS: list = []  # one engine per process; hypothesis examples reuse it

    def _mgr_h():
        if not _MGRS:
            _MGRS.append(_manager(_NET_H, _QPARAMS_H, window=9, stride=4))
        return _MGRS[0]

    @given(
        cuts=st.lists(st.integers(1, _T_H - 1), max_size=8, unique=True),
        sid=st.integers(0, 1 << 30),
    )
    @settings(max_examples=15, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    def test_random_chunk_schedules_serial_exact(cuts, sid):
        """Any cut set of the stream -- including empty (one shot) and dense
        (near-1-step chunks) -- reproduces the serial prefix-count oracle."""
        edges = [0] + sorted(cuts) + [_T_H]
        mgr = _mgr_h()
        name = f"h{sid}-{len(mgr.sessions)}"
        readouts, _ = _run_chunked(mgr, name, _RASTER_H, edges)
        _assert_readouts_serial(_NET_H, _QPARAMS_H, _RASTER_H, readouts, 9, 4, _T_H)
        mgr.close(name)

else:  # pragma: no cover - visible skip in environments without hypothesis

    @pytest.mark.skip(reason="hypothesis not installed (CI-only dependency)")
    def test_random_chunk_schedules_serial_exact():
        pass
