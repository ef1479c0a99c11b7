"""SNN serving launcher: continuous batching over the backend registry.

    PYTHONPATH=src python -m repro_torch.launch.serve_snn --requests 64 \\
        --max-batch 8 --backend event --rate 2000 [--device cpu]

Builds the paper's MNIST-scale 256-128-10 LIF network (random float weights
from ``torch.Generator().manual_seed(seed)``, then quantization -- the
serving path is precision-faithful regardless of training), generates a
request stream, and serves it through
:class:`~repro_torch.serve.snn_engine.SNNServeEngine` on ``--device``
(default ``cuda``).  ``--rate`` replays a Poisson arrival process at that
many requests/sec (0 = closed loop, everything queued up front);
``--density`` switches the workload from ``mnist_like`` rasters to
Bernoulli spike noise at the given density, which exercises the event
backend's sparse admission route.  Prints throughput, latency percentiles,
per-route counts, the scheduler's QoS counters, and the modeled hardware
operating point of a few sample requests.

QoS knobs drive the front-line scheduler: ``--critical-frac`` /
``--standard-frac`` split the workload across priority classes,
``--deadline-ms`` attaches an SLO to critical+standard requests,
``--degrade-bits`` registers coarser precision tiers that deadline
degradation may serve (with ``--degrade-steps-frac`` truncating the
window), and ``--no-preempt`` / ``--class-weights`` tune the admission
policy.

    PYTHONPATH=src python -m repro_torch.launch.serve_snn --http 8080 \\
        --degrade-bits 4 3 --deadline-ms 50

``--http`` skips the replay and serves the asyncio HTTP front-end instead
(``POST /submit``, ``POST /stream``, ``GET /metrics``, ``GET /healthz``,
plus the ``POST /session/*`` streaming-session routes -- see
:mod:`repro_torch.serve.http`); port 0 picks a free port and prints it.

    PYTHONPATH=src python -m repro_torch.launch.serve_snn --streaming 64 \\
        --stream-steps 400 --stream-chunk 16 --stream-idle 8

``--streaming`` replays a synthetic multi-stream workload instead of a
request batch: N concurrent forever-streams
(:mod:`repro_torch.serve.streaming` sessions) fed random-sized chunks in
random interleavings, with idle sessions evicted to a checkpoint store and
resumed bit-exactly on their next chunk.  Prints stream throughput
(steps/s, chunks/s, readouts/s) and the eviction/restore churn.

Every mode journals to ``--journal`` (default: a fresh temporary
directory; ``--no-journal`` turns it off); work left outstanding there by a
crashed run is recovered and re-served before the new workload.  SIGTERM or
SIGINT stops admission and drains what is in flight; a second signal
force-quits.  ``--data-parallel N`` shards the engine's lane pool across N
cards (clamped to the cards there are, then to a divisor of
``--max-batch``, as the JAX launcher does; one pool on a ``cpu`` engine).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import signal
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.network import NetworkConfig, init_float_params, quantize_params
from repro_torch.core.snn_layer import LayerConfig, NeuronModel
from repro_torch.data.snn_datasets import mnist_like
from repro_torch.serve.http import SNNHttpServer
from repro_torch.serve.journal import Journal, recover
from repro_torch.serve.scheduler import PrecisionTier, Priority, SchedPolicy
from repro_torch.serve.snn_engine import AsyncSNNServer, SNNRequest, SNNServeEngine
from repro_torch.serve.streaming import AsyncStreamServer, StreamConfig, StreamSessionManager


class _DrainRequested(BaseException):
    """Raised from the signal handler to unwind into the drain path.

    BaseException so the engine's ``except Exception`` nets cannot swallow
    the shutdown request mid-tick."""


@contextlib.contextmanager
def _drain_handlers(engine):
    """SIGTERM/SIGINT stop admission and unwind to a graceful drain.

    The first signal sets ``engine.stop_admission`` and raises
    :class:`_DrainRequested`; a second signal while draining force-quits
    with the conventional 130 status.  The previous handlers come back on
    exit."""

    def _handler(signum, frame):
        if engine.stop_admission:
            raise SystemExit(130)
        engine.stop_admission = True
        name = signal.Signals(signum).name
        print(
            f"\n[serve_snn] caught {name}: draining in-flight work (signal again to force-quit)",
            flush=True,
        )
        raise _DrainRequested()

    previous = {sig: signal.signal(sig, _handler) for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        yield
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def _close_journal(engine) -> None:
    if engine.journal is not None:
        engine.journal.close()


def _build_net(hidden: int, T: int) -> NetworkConfig:
    return NetworkConfig(
        layers=(
            LayerConfig(n_in=256, n_out=hidden, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
            LayerConfig(n_in=hidden, n_out=10, neuron=NeuronModel.LIF, w_bits=6, u_bits=16),
        ),
        n_steps=T,
        name=f"serve-256-{hidden}-10",
    )


def _stream_config(args, idle_budget=None) -> StreamConfig:
    return StreamConfig(
        window=args.stream_window, stride=args.stream_stride, idle_budget=idle_budget
    )


def _run_streaming(args, net, engine, apply_recovery) -> None:
    """Synthetic multi-stream replay: N sessions, random chunk sizes and
    interleavings, optional idle-eviction churn through the checkpointer."""
    rng = np.random.default_rng(args.seed)
    ckpt = args.stream_ckpt
    if ckpt is None and args.stream_idle is not None:
        ckpt = tempfile.mkdtemp(prefix="neura-stream-ckpt-")
    manager = StreamSessionManager(
        engine, checkpoint_dir=ckpt, config=_stream_config(args, args.stream_idle)
    )
    density = args.density if args.density is not None else 0.2
    # warmup resets pool + metrics: run it before any session bookkeeping
    engine.warmup(max(2 * args.stream_chunk, 8))
    apply_recovery(manager)
    remaining = {}
    for i in range(args.streaming):
        s = manager.open(f"stream{i}")
        remaining[s.sid] = args.stream_steps

    t0 = time.perf_counter()
    try:
        while any(remaining.values()) or not all(s.drained for s in manager.sessions.values()):
            for sid, left in remaining.items():
                # random interleaving: each poll round, each stream may feed
                if left and rng.random() < 0.5:
                    n = int(min(left, max(1, rng.poisson(args.stream_chunk))))
                    chunk = (rng.random((n, net.n_in)) < density).astype(np.uint8)
                    manager.feed(sid, chunk)
                    remaining[sid] = left - n
            manager.poll()
    except _DrainRequested:
        # graceful drain: stop feeding, finish what each lane holds, evict
        # to the checkpoint store when one exists, flush the journal
        while not all(s.drained for s in manager.sessions.values()):
            manager.poll()
        n_sessions = len(manager.sessions)
        if ckpt is not None:
            for sid in list(manager.sessions):
                manager.evict(sid)
        _close_journal(engine)
        n_left = sum(remaining.values())
        print(
            f"[serve_snn] drained {n_sessions} session(s) "
            f"({n_left} unfed steps abandoned); exiting cleanly"
        )
        sys.exit(0)
    span = time.perf_counter() - t0

    snap = engine.metrics.snapshot()
    c = snap["counters"]
    total_steps = args.streaming * args.stream_steps
    total_readouts = sum(s.n_readouts for s in manager.sessions.values())
    print(
        f"streamed {args.streaming} sessions x {args.stream_steps} steps on "
        f"{net.name} (max_batch={engine.max_batch}, chunk~{args.stream_chunk}, "
        f"window={args.stream_window}, stride={args.stream_stride}, device={engine.device})"
    )
    print(
        f"  throughput : {total_steps / span:.0f} steps/s  "
        f"{c.get('session_chunks', 0) / span:.1f} chunks/s  "
        f"{total_readouts / span:.1f} readouts/s  over {span * 1e3:.0f} ms"
    )
    ro = snap["streaming"]["readout_latency_ms"]
    print(
        f"  readout lat: p50={ro['p50']:.2f} ms  p99={ro['p99']:.2f} ms  "
        f"(n={ro['window_count']})"
    )
    print(
        f"  churn      : evictions={c.get('sessions_evicted', 0)} "
        f"restores={c.get('sessions_restored', 0)} ticks={engine.n_ticks}"
    )
    for sid in list(manager.sessions)[:3]:
        s = manager.sessions[sid]
        print(
            f"  {sid}: t_total={s.t_total} chunks={s.n_chunks} "
            f"readouts={s.n_readouts} evictions={s.n_evictions}"
        )
    _close_journal(engine)


async def _serve_http(args, engine, apply_recovery) -> None:
    async_server = AsyncSNNServer(engine)
    manager = StreamSessionManager(
        engine, checkpoint_dir=args.stream_ckpt, config=_stream_config(args, args.stream_idle)
    )
    server = SNNHttpServer(
        async_server, port=args.http, streaming=AsyncStreamServer(async_server, manager)
    )
    await server.start()
    apply_recovery(manager)
    # asyncio-native handlers replace the sync drain handlers: a signal sets
    # the stop event, the code below drains and exits 0
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    print(
        f"serving on http://{server.host}:{server.port} "
        "(POST /submit, POST /stream, POST /session/*, GET /metrics, GET /healthz)"
    )
    serve_task = asyncio.create_task(server.serve_forever())
    stop_task = asyncio.create_task(stop.wait())
    await asyncio.wait({serve_task, stop_task}, return_when=asyncio.FIRST_COMPLETED)
    if serve_task.done() and not stop.is_set():
        stop_task.cancel()
        serve_task.result()  # surfaced startup/serve failure
        return
    engine.stop_admission = True
    print("[serve_snn] caught signal: draining before shutdown", flush=True)
    serve_task.cancel()
    try:
        await serve_task
    except asyncio.CancelledError:
        pass
    await server.stop()
    while engine.in_flight or any(not s.drained for s in manager.sessions.values()):
        manager.poll()
        await asyncio.sleep(0)
    _close_journal(engine)
    print("[serve_snn] drained; exiting cleanly")


def _replay(args, net, engine, apply_recovery) -> None:
    rng = np.random.default_rng(args.seed)
    if args.density is not None:
        rasters = [
            (rng.random((args.T, net.n_in)) < args.density).astype(np.uint8)
            for _ in range(args.requests)
        ]
    else:
        ds = mnist_like(n=args.requests, T=args.T, seed=args.seed)
        rasters = [ds.spikes[i] for i in range(args.requests)]
    arrivals = (
        np.cumsum(rng.exponential(1.0 / args.rate, size=args.requests))
        if args.rate > 0
        else np.zeros(args.requests)
    )
    mix = np.array(
        [
            args.critical_frac,
            args.standard_frac,
            max(0.0, 1.0 - args.critical_frac - args.standard_frac),
        ]
    )
    classes = rng.choice(
        [Priority.CRITICAL, Priority.STANDARD, Priority.BEST_EFFORT],
        size=args.requests,
        p=mix / mix.sum(),
    )
    requests = [
        SNNRequest(
            uid=i,
            raster=r,
            arrival_s=float(a),
            priority=cls,
            deadline_s=(
                args.deadline_ms * 1e-3
                if args.deadline_ms is not None and cls != Priority.BEST_EFFORT
                else None
            ),
        )
        for i, (r, a, cls) in enumerate(zip(rasters, arrivals, classes))
    ]

    # build the kernels and touch every chunk length first, so the report
    # reflects steady-state service
    engine.warmup(args.T)
    rec_mgr = apply_recovery()

    def drain_recovered():
        # recovered sessions drain through their own manager
        while rec_mgr is not None and not all(s.drained for s in rec_mgr.sessions.values()):
            rec_mgr.poll()

    try:
        done = engine.run(requests)
        drain_recovered()
    except _DrainRequested:
        done = engine.drain()
        drain_recovered()
        _close_journal(engine)
        print(f"[serve_snn] drained {len(done)} in-flight request(s); exiting cleanly")
        return
    if not done:
        # e.g. --requests 0 against an already-drained journal
        _close_journal(engine)
        print(f"served 0 requests on {net.name}; nothing outstanding")
        return
    lat = np.asarray([r.latency_s for r in done]) * 1e3
    span = max(r._arrival_wall + r.latency_s for r in done) - min(r._arrival_wall for r in done)
    routes = {}
    for r in done:
        routes[r.route] = routes.get(r.route, 0) + 1
    print(
        f"served {len(done)} requests on {net.name} (backend={args.backend}, "
        f"max_batch={args.max_batch}, rate={args.rate or 'closed-loop'}, device={engine.device})"
    )
    print(f"  throughput : {len(done) / span:.1f} samples/s over {span * 1e3:.0f} ms")
    print(
        f"  latency    : p50={np.percentile(lat, 50):.2f} ms  "
        f"p99={np.percentile(lat, 99):.2f} ms"
    )
    print(f"  routes     : {routes}  (ticks={engine.n_ticks})")
    snap = engine.metrics.snapshot()
    qos = {
        k: snap["counters"].get(k, 0)
        for k in ("completed", "degraded", "rejected", "preempted", "resumed")
    }
    print(f"  qos        : {qos}")
    for cls, stats in snap["latency"].items():
        if cls != "all":
            print(
                f"    {cls:<12}: p50={stats['p50_ms']:.2f} ms  "
                f"p99={stats['p99_ms']:.2f} ms  (n={stats['window_count']})"
            )
    for r in sorted((r for r in done if r.status == "completed"), key=lambda r: r.uid)[:4]:
        dp = r.design
        print(
            f"  req{r.uid}: pred={r.prediction} route={r.route} "
            f"latency={r.latency_s * 1e3:.2f} ms | modeled HW: "
            f"{dp.latency_s * 1e3:.2f} ms, {dp.energy_per_image_j * 1e3:.3f} mJ, "
            f"{dp.events_per_image:.0f} events"
        )
    _close_journal(engine)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument(
        "--backend",
        default="reference",
        help="lane-pool numerics are shared; 'event' enables sparse admission",
    )
    ap.add_argument(
        "--rate", type=float, default=0.0, help="offered load in requests/sec (0 = closed loop)"
    )
    ap.add_argument("--T", type=int, default=20)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument(
        "--density",
        type=float,
        default=None,
        help="Bernoulli raster density instead of mnist-like requests",
    )
    ap.add_argument("--sparse-threshold", type=float, default=0.10)
    ap.add_argument(
        "--data-parallel",
        type=int,
        default=None,
        help="shard the lane pool across this many cards "
        "(clamped to what exists; must divide --max-batch)",
    )
    ap.add_argument(
        "--critical-frac",
        type=float,
        default=0.0,
        help="fraction of requests submitted as CRITICAL",
    )
    ap.add_argument(
        "--standard-frac",
        type=float,
        default=1.0,
        help="fraction submitted as STANDARD (remainder BEST_EFFORT)",
    )
    ap.add_argument(
        "--deadline-ms",
        type=float,
        default=None,
        help="latency SLO attached to critical+standard requests",
    )
    ap.add_argument(
        "--degrade-bits",
        type=int,
        nargs="*",
        default=[],
        help="register degradation tiers at these w_bits, finest first",
    )
    ap.add_argument(
        "--degrade-steps-frac",
        type=float,
        default=1.0,
        help="window fraction the degradation tiers serve",
    )
    ap.add_argument(
        "--class-weights",
        default="8,3,1",
        help="admission credits per DRR cycle: CRITICAL,STANDARD,BEST_EFFORT",
    )
    ap.add_argument(
        "--no-preempt", action="store_true", help="disable CRITICAL preemption of running lanes"
    )
    ap.add_argument(
        "--http",
        type=int,
        default=None,
        metavar="PORT",
        help="serve the HTTP front-end on this port instead of replaying a "
        "workload (0 = pick a free port)",
    )
    ap.add_argument(
        "--streaming",
        type=int,
        default=None,
        metavar="N",
        help="replay a synthetic workload of N concurrent streaming sessions "
        "instead of a request batch",
    )
    ap.add_argument(
        "--stream-steps", type=int, default=200, help="total raster steps each stream delivers"
    )
    ap.add_argument(
        "--stream-chunk", type=int, default=16, help="mean chunk size (steps) of each feed"
    )
    ap.add_argument("--stream-window", type=int, default=16)
    ap.add_argument("--stream-stride", type=int, default=8)
    ap.add_argument(
        "--stream-idle",
        type=int,
        default=None,
        help="idle-poll budget before a drained session is evicted to the "
        "checkpoint store (default: no eviction)",
    )
    ap.add_argument(
        "--stream-ckpt",
        default=None,
        metavar="DIR",
        help="checkpoint directory for evicted session carries "
        "(default: a temp dir when --stream-idle is set)",
    )
    ap.add_argument(
        "--journal",
        default=None,
        metavar="DIR",
        help="write-ahead journal directory (default: a temp dir); outstanding "
        "work found there is recovered and re-served before the new workload",
    )
    ap.add_argument(
        "--no-journal", action="store_true", help="disable the write-ahead journal entirely"
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    net = _build_net(args.hidden, args.T)
    params = init_float_params(torch.Generator().manual_seed(args.seed), net, device=device)
    qparams, _ = quantize_params(net, params)
    policy = SchedPolicy(
        class_weights=tuple(int(w) for w in args.class_weights.split(",")),
        preempt=not args.no_preempt,
    )
    tiers = [
        PrecisionTier.from_params(net, params, w_bits=b, steps_fraction=args.degrade_steps_frac)
        for b in args.degrade_bits
    ]
    engine = SNNServeEngine(
        net,
        qparams,
        max_batch=args.max_batch,
        backend=args.backend,
        sparse_admission_threshold=args.sparse_threshold,
        data_parallel=args.data_parallel,
        scheduler=policy,
        precision_tiers=tiers,
        device=device,
    )

    recovered = None
    if not args.no_journal:
        journal_dir = args.journal or tempfile.mkdtemp(prefix="neura-journal-")
        # opening repairs any torn tail from a previous crash before the
        # first append of this run
        engine.journal = Journal(journal_dir)
        print(f"journaling to {journal_dir}")
        recovered = recover(journal_dir, checkpoint_dir=args.stream_ckpt)

    def apply_recovery(manager=None):
        # outstanding work from a crashed run: resubmit/re-feed it ahead of
        # this run's workload.  Must run after warmup (which requires an
        # idle engine), hence the deferred call sites per mode.
        if recovered is None or not (recovered.requests or recovered.sessions):
            return manager
        mgr = manager
        if recovered.sessions and mgr is None:
            mgr = StreamSessionManager(
                engine, checkpoint_dir=args.stream_ckpt, config=_stream_config(args)
            )
        summary = recovered.apply(engine, mgr)
        print(f"recovered from journal: {summary}")
        return mgr

    with _drain_handlers(engine):
        try:
            if args.http is not None:
                engine.warmup(args.T)
                asyncio.run(_serve_http(args, engine, apply_recovery))
            elif args.streaming is not None:
                _run_streaming(args, net, engine, apply_recovery)
            else:
                _replay(args, net, engine, apply_recovery)
        except _DrainRequested:
            # a signal before any workload was in flight: nothing to drain
            _close_journal(engine)


if __name__ == "__main__":
    main()
