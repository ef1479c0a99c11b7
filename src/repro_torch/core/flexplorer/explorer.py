"""Flex-plorer end-to-end DSE entry point (port of ``repro/core/flexplorer/explorer.py``).

SNN mode (paper-faithful): given a *trained* network, search over
(feed-forward weight bits, recurrent weight bits, leak precision); each
candidate is quantized and scored by the bit-exact hardware simulator
(``run_int``) on a held-out set, plus the analytical LUT/FF/BRAM model.

The entry point is ``explore_snn(net, float_params, eval_ds, search=...,
evaluate=..., refine=...)`` with three spec dataclasses:

* :class:`SearchSpec` -- *what to search and how*: the knob space, cost
  weights, target device, the pluggable strategy (``"anneal"`` -- the
  paper's simulated annealer, serial or population-parallel -- or
  ``"nsga2"`` -- multi-objective Pareto search; see
  ``repro_torch.core.flexplorer.strategies``), and search-state
  checkpointing so a killed search resumes mid-schedule.
* :class:`EvalSpec` -- *how candidates are scored*: simulator backend,
  eval batch size, device mesh, perf-cost targets.
* :class:`RefineSpec` -- the optional second QAT train-in-the-loop phase
  over the search finalists (``snn.qat.refine_candidates``: all finalists
  fine-tune at once on a stacked candidate axis).

Population-capable strategies score each round's uncached candidates
through one population sweep (``eval_int_population``: on the card every
layer's currents through ``spike_matmul`` and the feed-forward membrane
scans through ``lif_scan``, all candidates of a shard per launch), its
candidate axis split across ``evaluate.mesh``'s devices and -- when a
``torch.distributed`` process group is up (``compat.maybe_init_distributed``)
-- partitioned across *processes* first: each process sweeps its slice and
the scores and event statistics are all-gathered.

The legacy 15-kwarg signature (``space=``, ``anneal_cfg=``, ``eval_batch=``,
``refine_top_k=``, ...) still works through a deprecation shim that warns
once per process and maps onto the specs; see ``docs/EXPLORER.md`` for the
migration table.

Everything else follows the JAX version line for line, so a seeded search
here gives the same trace, front and ``to_json()`` as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np

from repro_torch.core import backend as backend_lib
from repro_torch.core import hw_model
from repro_torch.core import shard as shard_lib
from repro_torch.core.flexplorer import cost as cost_lib
from repro_torch.core.flexplorer import strategies as strategies_lib
from repro_torch.core.network import NetworkConfig, quantize_params
from repro_torch.data.snn_datasets import SpikeDataset
from repro_torch.distributed import compat
from repro_torch.snn import qat as qat_lib
from repro_torch.snn.train import eval_int, eval_int_population

__all__ = [
    "SNNSearchSpace",
    "SearchSpec",
    "EvalSpec",
    "RefineSpec",
    "RefinedCandidate",
    "ExplorationResult",
    "pareto_front",
    "explore_snn",
]


@dataclasses.dataclass(frozen=True)
class SNNSearchSpace:
    ff_bits: Sequence[int] = (4, 6, 8)
    rec_bits: Sequence[int] = (4, 6, 8)
    leak_bits: Sequence[int] = (3, 8)


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """What to search and how: space, objective, device, strategy, resume.

    ``strategy`` names a registered search strategy (``"anneal"`` /
    ``"nsga2"``); ``config`` is its schedule (:class:`~repro_torch.core.
    flexplorer.strategies.AnnealConfig` / :class:`~repro_torch.core.flexplorer.
    strategies.NSGAConfig`, None = defaults).  ``population`` switches the
    annealer to population-parallel mode (> 1) and doubles as the default
    NSGA-II population when no ``config`` is given.

    ``checkpoint_dir`` makes the search resumable: the complete search
    state (cache, trace, strategy RNG/schedule) snapshots to a
    ``repro_torch.checkpoint.Checkpointer`` there every ``checkpoint_every``
    rounds, and a fresh ``explore_snn`` call over the same directory
    resumes mid-schedule (``resume=False`` ignores an existing snapshot).
    ``max_evaluations`` caps the number of scored candidates (the
    equal-budget lever for comparing strategies).
    """

    space: SNNSearchSpace = SNNSearchSpace()
    weights: cost_lib.CostWeights = cost_lib.CostWeights()
    device: cost_lib.DeviceCapacity = cost_lib.XC7Z020
    strategy: str = "anneal"
    config: object | None = None
    population: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = True
    max_evaluations: int | None = None


@dataclasses.dataclass(frozen=True)
class EvalSpec:
    """How candidates are scored: backend, batch, mesh, perf targets.
    ``mesh`` is ``None`` | ``"auto"`` | int | ``repro_torch.core.shard.
    DeviceMesh``."""

    backend: object = "reference"
    batch: int = 512
    mesh: object = None
    perf_targets: cost_lib.PerfTargets = cost_lib.PerfTargets()


@dataclasses.dataclass(frozen=True)
class RefineSpec:
    """The optional QAT train-in-the-loop phase over the search finalists."""

    top_k: int = 0
    train_ds: SpikeDataset | None = None
    epochs: int = 2
    batch: int = 128
    lr: float = 5e-4


def pareto_front(points: Sequence[dict]) -> list[dict]:
    """Non-dominated subset of ``{"hw_cost", "accuracy", ...}`` points.

    A point dominates another when its hardware cost is <= and its accuracy
    >= with at least one strict -- the two axes the paper's Fig.-11 trade-off
    plot spans.  Returned sorted by ascending hardware cost.
    """
    front: list[dict] = []
    for p in sorted(points, key=lambda d: (d["hw_cost"], -d["accuracy"])):
        if not front or p["accuracy"] > front[-1]["accuracy"]:
            front.append(p)
    return front


@dataclasses.dataclass
class RefinedCandidate:
    """One search finalist after QAT fine-tuning at its own precision.

    ``accuracy`` is the bit-exact quantized accuracy of the refined
    parameters (``base_accuracy`` the unrefined, post-training-quant score
    the search saw -- ``accuracy >= base_accuracy`` by construction, see
    ``qat.refine_candidates``); ``qparams`` deploy through the unchanged
    ``eval_int`` / serving paths.
    """

    cfg: tuple
    breakdown: dict
    net: NetworkConfig
    qparams: list
    params: list
    accuracy: float
    base_accuracy: float
    hw_cost: float
    total_cost: float
    perf_cost: float = 0.0

    def point(self) -> dict:
        return {
            "cfg": self.breakdown,
            "hw_cost": self.hw_cost,
            "accuracy": self.accuracy,
            "base_accuracy": self.base_accuracy,
            "refined": True,
        }


@dataclasses.dataclass
class ExplorationResult:
    best_net: NetworkConfig
    best_qparams: list
    search: strategies_lib.SearchResult
    weights: cost_lib.CostWeights
    # second-phase QAT refinement outcomes (empty unless refine.top_k > 0);
    # best_net/best_qparams stay the *unrefined* search incumbent so the
    # paper-faithful single-phase contract is unchanged -- consumers opt in
    # to the refined front explicitly.
    refined: list[RefinedCandidate] = dataclasses.field(default_factory=list)

    # ``anneal`` was the historical name of the search-result field; keep it
    # as an alias (both directions, so artifacts pickled before the rename
    # still expose ``.search``).
    @property
    def anneal(self) -> strategies_lib.SearchResult:
        return self.__dict__.get("search") or self.__dict__["anneal"]

    def __getattr__(self, name):
        if name == "search" and "anneal" in self.__dict__:
            return self.__dict__["anneal"]
        raise AttributeError(name)

    def _explored_points(self) -> list[dict]:
        return [
            {"cfg": t["cfg"], "hw_cost": t["hw"], "accuracy": t["accuracy"], "refined": False}
            for t in self.search.trace
        ]

    def explored_front(self) -> list[dict]:
        """Pareto front of every candidate the search scored (PTQ only)."""
        return pareto_front(self._explored_points())

    def refined_front(self) -> list[dict]:
        """Pareto front over explored *and* refined points (both phases)."""
        return pareto_front(self._explored_points() + [r.point() for r in self.refined])

    def report(self) -> dict:
        res = hw_model.network_resources(self.best_net)
        out = {
            "chosen": self.search.best_breakdown,
            "lut": res.lut,
            "ff": res.ff,
            "bram": res.bram,
            "logic_cells": res.logic_cells,
            "evaluations": self.search.evaluations,
            "strategy": self.search.strategy,
        }
        if self.refined:
            out["refined"] = [
                {
                    "cfg": r.breakdown,
                    "accuracy": r.accuracy,
                    "base_accuracy": r.base_accuracy,
                    "total_cost": r.total_cost,
                }
                for r in self.refined
            ]
        return out

    def to_json(self) -> dict:
        """Uniform serialisation, identical schema for every strategy."""
        out = self.search.to_json()
        out["weights"] = dataclasses.asdict(self.weights)
        out["explored_front"] = self.explored_front()
        out["refined_front"] = self.refined_front() if self.refined else None
        out["refined"] = [
            r.point() | {"total_cost": r.total_cost, "perf_cost": r.perf_cost}
            for r in self.refined
        ]
        return out


# --------------------------------------------------------------------------
# Legacy kwargs -> spec fields (deprecation shim)
# --------------------------------------------------------------------------

_LEGACY_KWARGS = {
    "space": ("search", "space"),
    "weights": ("search", "weights"),
    "device": ("search", "device"),
    "anneal_cfg": ("search", "config"),
    "population": ("search", "population"),
    "eval_batch": ("evaluate", "batch"),
    "backend": ("evaluate", "backend"),
    "mesh": ("evaluate", "mesh"),
    "perf_targets": ("evaluate", "perf_targets"),
    "refine_top_k": ("refine", "top_k"),
    "refine_train_ds": ("refine", "train_ds"),
    "refine_epochs": ("refine", "epochs"),
    "refine_batch": ("refine", "batch"),
    "refine_lr": ("refine", "lr"),
}

_LEGACY_WARNED = False


def _apply_legacy_kwargs(search, evaluate, refine, legacy: dict):
    global _LEGACY_WARNED
    unknown = set(legacy) - set(_LEGACY_KWARGS)
    if unknown:
        raise TypeError(f"explore_snn() got unexpected keyword arguments {sorted(unknown)}")
    if not _LEGACY_WARNED:
        mapped = ", ".join(
            f"{k}= -> {grp}.{field}" for k, (grp, field) in sorted(_LEGACY_KWARGS.items()) if k in legacy
        )
        warnings.warn(
            "explore_snn: flat keyword arguments are deprecated; pass "
            "SearchSpec/EvalSpec/RefineSpec instead (" + mapped + "; see "
            "docs/EXPLORER.md for the migration table)",
            DeprecationWarning,
            stacklevel=3,
        )
        _LEGACY_WARNED = True
    provided = {"search": search, "evaluate": evaluate, "refine": refine}
    groups = {"search": search or SearchSpec(), "evaluate": evaluate or EvalSpec(), "refine": refine or RefineSpec()}
    for key, value in legacy.items():
        grp, field = _LEGACY_KWARGS[key]
        if provided[grp] is not None:
            raise TypeError(
                f"explore_snn() got both {grp}= and legacy {key}=; move {key} "
                f"into the {type(provided[grp]).__name__}"
            )
        groups[grp] = dataclasses.replace(groups[grp], **{field: value})
    return groups["search"], groups["evaluate"], groups["refine"]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def explore_snn(
    net: NetworkConfig,
    float_params: list,
    eval_ds: SpikeDataset,
    search: SearchSpec | None = None,
    evaluate: EvalSpec | None = None,
    refine: RefineSpec | None = None,
    **legacy,
) -> ExplorationResult:
    """Search precision knobs for a trained SNN (the paper's Explorer stage).

    ``search.strategy`` picks the search algorithm: ``"anneal"`` is the
    paper's simulated annealer (serial, or population-parallel when
    ``search.population > 1``); ``"nsga2"`` is multi-objective NSGA-II over
    accuracy x hardware cost (x latency x energy x bandwidth congestion
    when ``weights.c_perf > 0``), whose result carries the full Pareto
    front in ``result.search.front``.  Population-capable strategies score
    each round through one dynamic-register population sweep (still
    bit-exact) and therefore *override* ``evaluate.backend`` -- a warning
    is issued if a backend differing from the default reference engine is
    requested alongside one.

    Candidates are scored on the device of ``float_params`` (the card, or
    the CPU where the caller built them there).  ``evaluate.mesh`` spreads
    the evaluation across devices (the serial search's samples, the
    population sweeps' candidates), and sweep widths round up to the shard
    multiple so every sweep ships full shards (the annealer's speculative
    lane fill scores fresh candidates in the spare lanes).  When a process
    group is configured (torchrun's environment; see
    ``compat.maybe_init_distributed``) the candidate axis is also
    partitioned across processes and all-gathered after each sweep; a
    single process is unaffected.

    When ``search.weights.c_perf > 0`` the objective gains an event-aware
    perf term: each candidate's simulated event traffic (measured during
    the same accuracy evaluation -- no extra simulation) drives the
    calibrated latency/energy model, normalised against
    ``evaluate.perf_targets``, plus -- when ``weights.c_bw > 0`` -- the
    memory-bandwidth congestion penalty against
    ``search.device.mem_bw_bytes_s`` (see ``hw_model.bandwidth_profile``).

    ``search.checkpoint_dir`` makes the search resumable across process
    kills; see :class:`SearchSpec`.

    ``refine.top_k > 0`` adds the second *train-in-the-loop* phase: the
    top-k finalists (Pareto-front members first, then cheapest total cost)
    are QAT-fine-tuned at their own precisions on ``refine.train_ds``
    (required) -- one candidate-axis train step for all of them -- and
    re-scored bit-exactly; with ``c_perf > 0`` their traffic is re-measured
    through ``eval_int``.  Results land in ``result.refined``;
    ``best_net``/``best_qparams`` remain the unrefined incumbent.

    Legacy flat kwargs (``space=``, ``anneal_cfg=``, ``population=``,
    ``eval_batch=``, ``refine_top_k=``, ...) are accepted through a shim
    that warns once per process; see ``docs/EXPLORER.md``.
    """
    if legacy:
        search, evaluate, refine = _apply_legacy_kwargs(search, evaluate, refine, legacy)
    search = search or SearchSpec()
    evaluate = evaluate or EvalSpec()
    refine = refine or RefineSpec()
    weights, device, perf_targets = search.weights, search.device, evaluate.perf_targets
    backend, eval_batch = evaluate.backend, evaluate.batch

    if refine.top_k > 0 and refine.train_ds is None:
        raise ValueError(
            "explore_snn: refine.top_k > 0 needs refine.train_ds (legacy "
            "kwarg refine_train_ds) -- the data the finalists are "
            "QAT-fine-tuned on; typically the training split the float "
            "parameters came from"
        )

    any_recurrent = any(lc.is_recurrent for lc in net.layers)
    knobs = {"ff_bits": list(search.space.ff_bits)}
    if any_recurrent:
        knobs["rec_bits"] = list(search.space.rec_bits)
    knobs["leak_bits"] = list(search.space.leak_bits)

    # -- strategy + evaluation-path selection -------------------------------
    compat.maybe_init_distributed()
    n_hosts = compat.process_count()
    dmesh = shard_lib.resolve_mesh(evaluate.mesh)
    n_shards = dmesh.n_shards if dmesh is not None else 1
    width_unit = n_shards * n_hosts

    serial_mode = search.strategy == "anneal" and search.population <= 1
    # Population sweeps ship whole shards on every process: round the sweep
    # width up so the spare lanes carry speculative candidates (annealer)
    # or padding (NSGA-II) instead of shard remainders.
    sweep_width = (
        -(-search.population // width_unit) * width_unit if search.population > 1 else 0
    )
    strategy = strategies_lib.make_strategy(
        search.strategy,
        knobs,
        config=search.config,
        population=search.population,
        fill_width=sweep_width or None,
    )
    fixed_width = sweep_width if isinstance(strategy, strategies_lib.PopulationAnnealStrategy) else 0

    is_default_backend = (
        backend == "reference"
        or backend_lib.get_backend(backend) == backend_lib.ReferenceBackend()
    )
    if not serial_mode and not is_default_backend:
        warnings.warn(
            "explore_snn: population-mode strategies score candidates "
            "through their own population sweep (reference semantics); backend="
            f"{getattr(backend, 'name', backend)!r} is ignored",
            stacklevel=2,
        )

    use_perf = weights.c_perf > 0

    def cfg_to_net(cfg: tuple) -> NetworkConfig:
        kv = dict(zip(knobs.keys(), cfg))
        return net.replace_precisions(
            w_bits=kv["ff_bits"],
            w_rec_bits=kv.get("rec_bits", kv["ff_bits"]),
            leak_bits=kv["leak_bits"],
        )

    def hw_cost_fn(cfg: tuple) -> float:
        res = hw_model.network_resources(cfg_to_net(cfg))
        return cost_lib.hw_cost(res, weights, device)

    # cfg -> event-traffic stats dict, filled by whichever accuracy evaluator
    # ran the candidate (the perf cost reuses that simulation's traffic).
    stats_stash: dict = {}

    qp_cache: dict = {}

    def quantized(cfg: tuple):
        # Quantization is pure in (cfg, float_params); memoise so padding
        # duplicates and re-proposed candidates cost nothing.
        if cfg not in qp_cache:
            cand = cfg_to_net(cfg)
            qp_cache[cfg] = (cand, quantize_params(cand, float_params)[0])
        return qp_cache[cfg]

    def serial_acc_fn(cfg: tuple) -> float:
        cand, qparams = quantized(cfg)
        if use_perf:
            acc, stats = eval_int(
                cand, qparams, eval_ds, batch_size=eval_batch,
                return_stats=True, backend=backend, mesh=dmesh,
            )
            stats_stash[cfg] = stats
            return acc
        return eval_int(
            cand, qparams, eval_ds, batch_size=eval_batch, backend=backend, mesh=dmesh
        )

    def sweep_acc_fn(cfg_batch: list) -> np.ndarray:
        # Pad to a fixed width (the annealer's sweep width) or to the next
        # power-of-two bucket of the batch (NSGA-II's generation batches
        # vary), rounded up to whole shards on every process, as the JAX
        # version does: the padding lanes score duplicates of the last
        # candidate, so the scores -- and the search -- are the same in
        # both packages.
        if fixed_width:
            width = fixed_width
        else:
            width = -(-_next_pow2(len(cfg_batch)) // width_unit) * width_unit
        padded = list(cfg_batch) + [cfg_batch[-1]] * (width - len(cfg_batch))
        lo, hi = shard_lib.host_bounds(len(padded)) if n_hosts > 1 else (0, len(padded))
        nets, qps = zip(*(quantized(c) for c in padded[lo:hi]))
        if use_perf:
            accs, stats = eval_int_population(
                net, list(nets), list(qps), eval_ds, batch_size=eval_batch,
                return_stats=True, mesh=dmesh,
            )
            accs = _gather_population(accs, stats, padded, n_hosts, stats_stash)
        else:
            accs = eval_int_population(
                net, list(nets), list(qps), eval_ds, batch_size=eval_batch, mesh=dmesh
            )
            accs = shard_lib.allgather_hosts(np.asarray(accs)) if n_hosts > 1 else accs
        return np.asarray(accs)[: len(cfg_batch)]

    batch_acc_fn = (
        (lambda batch: [float(serial_acc_fn(c)) for c in batch]) if serial_mode else sweep_acc_fn
    )

    def acc_cost_fn(accuracy: float) -> float:
        return cost_lib.acc_cost(accuracy, weights)

    # cfg -> (DesignPoint, bw congestion): one modeled operating point per
    # candidate, shared by the perf cost, the metrics, and the objectives.
    dp_cache: dict = {}

    def design_for(cfg: tuple):
        if cfg not in dp_cache:
            traffic = hw_model.EventTraffic.from_stats(stats_stash[cfg])
            dp = hw_model.design_point(cfg_to_net(cfg), traffic)
            congestion = max(0.0, dp.bw_demand_bytes_s / device.mem_bw_bytes_s - 1.0)
            dp_cache[cfg] = (dp, congestion)
        return dp_cache[cfg]

    def perf_cost_fn(cfg: tuple) -> float:
        dp, congestion = design_for(cfg)
        return cost_lib.perf_cost(
            dp.latency_s, dp.energy_per_image_j, weights, perf_targets,
            bw_congestion=congestion,
        )

    def perf_metrics_fn(cfg: tuple) -> dict:
        dp, congestion = design_for(cfg)
        return {
            "latency_s": dp.latency_s,
            "energy_j": dp.energy_per_image_j,
            "bw_demand_bytes_s": dp.bw_demand_bytes_s,
            "bw_congestion": congestion,
        }

    def perf_objectives_fn(cfg: tuple, rec) -> list[float]:
        # the four-axis trade-off: accuracy x hardware x latency x energy
        # (plus congestion when the bandwidth weight is on), all minimised
        m = rec.metrics
        objs = [
            1.0 - rec.accuracy,
            rec.hw_cost,
            m["latency_s"] / perf_targets.latency_s,
            m["energy_j"] / perf_targets.energy_j,
        ]
        if weights.c_bw:
            objs.append(m["bw_congestion"])
        return objs

    checkpointer = None
    if search.checkpoint_dir is not None:
        from repro_torch.checkpoint.checkpointer import Checkpointer

        checkpointer = Checkpointer(search.checkpoint_dir)

    result = strategies_lib.run_search(
        strategy,
        knobs,
        hw_cost_fn,
        batch_acc_fn=batch_acc_fn,
        acc_cost_fn=acc_cost_fn,
        extra_cost_fn=perf_cost_fn if use_perf else None,
        metrics_fn=perf_metrics_fn if use_perf else None,
        objectives_fn=perf_objectives_fn if use_perf else None,
        checkpointer=checkpointer,
        snapshot_every=search.checkpoint_every,
        max_evaluations=search.max_evaluations,
        resume=search.resume,
    )
    # every scored candidate passed through quantized(); the best's entry is
    # guaranteed cached, so closing out costs no requantization
    best_net, best_qparams = quantized(result.best)

    refined: list[RefinedCandidate] = []
    if refine.top_k > 0:
        seed = getattr(search.config, "seed", 0) if search.config is not None else 0
        chosen = _select_finalists(result, refine.top_k)
        cand_nets = [quantized(c)[0] for c in chosen]
        rr = qat_lib.refine_candidates(
            net,
            cand_nets,
            float_params,
            refine.train_ds,
            eval_ds,
            epochs=refine.epochs,
            batch_size=refine.batch,
            lr=refine.lr,
            seed=seed,
            eval_batch=eval_batch,
            mesh=dmesh,
        )
        for k, cfg in enumerate(chosen):
            cand = cand_nets[k]
            refined_params = rr.params[k]
            qp = quantize_params(cand, refined_params)[0]
            accuracy = float(rr.best_acc[k])
            p_cost = 0.0
            if use_perf:
                # the refined parameters spike differently: re-measure traffic
                accuracy, stats = eval_int(
                    cand, qp, eval_ds, batch_size=eval_batch,
                    return_stats=True, backend=backend, mesh=dmesh,
                )
                traffic = hw_model.EventTraffic.from_stats(stats)
                dp = hw_model.design_point(cand, traffic)
                congestion = max(0.0, dp.bw_demand_bytes_s / device.mem_bw_bytes_s - 1.0)
                p_cost = cost_lib.perf_cost(
                    dp.latency_s, dp.energy_per_image_j, weights, perf_targets,
                    bw_congestion=congestion,
                )
            hw = float(result.cache[cfg][1])
            refined.append(
                RefinedCandidate(
                    cfg=cfg,
                    breakdown=dict(zip(knobs.keys(), cfg)),
                    net=cand,
                    qparams=qp,
                    params=refined_params,
                    accuracy=float(accuracy),
                    base_accuracy=float(rr.base_acc[k]),
                    hw_cost=hw,
                    total_cost=hw + float(acc_cost_fn(float(accuracy))) + p_cost,
                    perf_cost=p_cost,
                )
            )

    return ExplorationResult(
        best_net=best_net,
        best_qparams=best_qparams,
        search=result,
        weights=weights,
        refined=refined,
    )


def _gather_population(accs, stats, padded, n_hosts, stats_stash) -> np.ndarray:
    """Stash per-candidate stats and all-gather accs/stats across processes."""
    if n_hosts > 1:
        in_ev = np.stack([np.asarray(s["input_events_per_step"]) for s in stats])
        layer_ev = np.stack(
            [np.stack([np.asarray(e) for e in s["layer_events_per_step"]]) for s in stats]
        )
        accs = shard_lib.allgather_hosts(np.asarray(accs))
        in_ev = shard_lib.allgather_hosts(in_ev)
        layer_ev = shard_lib.allgather_hosts(layer_ev)
        stats = [
            {
                "input_events_per_step": in_ev[i],
                "layer_events_per_step": [layer_ev[i, li] for li in range(layer_ev.shape[1])],
            }
            for i in range(len(padded))
        ]
    for c, s in zip(padded, stats):
        stats_stash[c] = s
    return np.asarray(accs)


def _select_finalists(result, top_k: int) -> list[tuple]:
    """The refinement shortlist: Pareto-front members first, then by cost.

    Front members are where extra accuracy moves the achievable trade-off
    outward (a refined front point dominates its own unrefined twin, so the
    refined front is never worse); remaining slots go to the cheapest
    non-front candidates.
    """
    points = [
        {"cfg": cfg, "hw_cost": hw, "accuracy": accuracy, "total": total}
        for cfg, (total, hw, _a, accuracy, _p) in result.cache.items()
    ]
    front = pareto_front(points)
    front_cfgs = [p["cfg"] for p in sorted(front, key=lambda d: d["total"])]
    rest = sorted(
        (p for p in points if p["cfg"] not in set(front_cfgs)),
        key=lambda d: d["total"],
    )
    order = front_cfgs + [p["cfg"] for p in rest]
    return order[:top_k]
