"""Pluggable Flex-plorer search strategies over a discrete knob space.

The paper's Explorer is one simulated annealer; this module generalises it
into a *strategy protocol* so the same search loop can run the paper-faithful
annealer, its population-parallel variant, or a multi-objective NSGA-II
search -- and so new strategies plug in without touching the explorer.

The protocol (see :class:`SearchStrategy`):

* ``propose(cache)``  -- return the configurations to evaluate this round
  (the search loop scores only the ones missing from ``cache``);
* ``observe(cache)``  -- digest the freshly scored results and advance the
  internal state (walkers, temperature, generation, ...);
* ``finished``        -- True when the schedule is exhausted;
* ``state_dict()`` / ``load_state_dict()`` -- the *complete* search state
  (including the RNG bit-generator state) as a JSON-serialisable dict, so
  a search snapshots to ``repro_torch.checkpoint`` and a killed search resumes
  mid-schedule on the exact trajectory it would have taken.

:func:`run_search` is the strategy-agnostic search loop: it owns the evaluation
cache/trace, pre-computes every candidate's hardware cost (the paper's
lines 8-13), scores fresh proposals through a caller-supplied batch
evaluator, snapshots after every ``snapshot_every`` rounds, and returns a
:class:`SearchResult` -- the uniform result schema (trace / cache / front /
evaluations) shared by every strategy.  ``AnnealResult`` is kept as an
alias in ``repro_torch.core.flexplorer.annealer`` so artifacts and imports from
earlier PRs keep working.

Determinism contract: a strategy draws from its own seeded
``numpy.random.Generator`` in a fixed order, and evaluation is pure in the
configuration, so (seed, knobs, evaluator) fully determine the search --
two runs are identical, and a resume from any snapshot replays the
uninterrupted trajectory bit-for-bit (held by ``tests/test_strategies.py``).

This is the port's copy of ``repro/core/flexplorer/strategies.py``: numpy
only, the same draws in the same order, so a seeded search here follows the
JAX package's trajectory exactly (``tests/test_torch_flexplorer.py``); its
snapshots go through the port's own checkpointer.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Mapping, Sequence

import numpy as np

__all__ = [
    "EvalRecord",
    "SearchResult",
    "SearchStrategy",
    "AnnealConfig",
    "AnnealStrategy",
    "PopulationAnnealStrategy",
    "NSGAConfig",
    "NSGAStrategy",
    "enumerate_configs",
    "neighbor",
    "dominates",
    "non_dominated_sort",
    "crowding_distance",
    "register_strategy",
    "available_strategies",
    "make_strategy",
    "run_search",
]


# ---------------------------------------------------------------------------
# Shared knob-space helpers
# ---------------------------------------------------------------------------


def enumerate_configs(knobs: Mapping[str, Sequence]) -> tuple[tuple[str, ...], list[tuple]]:
    """Cartesian product of knob value lists -> (knob names, candidate tuples)."""
    names = tuple(knobs.keys())
    values = [list(v) for v in knobs.values()]
    return names, list(itertools.product(*values))


def neighbor(cfg: tuple, knob_values: list[list], rng: np.random.Generator) -> tuple:
    """Change exactly one knob to an adjacent value in its ordered list."""
    cfg = list(cfg)
    movable = [i for i, vals in enumerate(knob_values) if len(vals) > 1]
    i = int(rng.choice(movable))
    vals = knob_values[i]
    j = vals.index(cfg[i])
    if j == 0:
        j2 = 1
    elif j == len(vals) - 1:
        j2 = j - 1
    else:
        j2 = j + int(rng.choice([-1, 1]))
    cfg[i] = vals[j2]
    return tuple(cfg)


# ---------------------------------------------------------------------------
# Evaluation records and the uniform result schema
# ---------------------------------------------------------------------------


def _rebuild_eval_record(values, objectives, metrics):
    return EvalRecord(*values, objectives=objectives, metrics=metrics)


class EvalRecord(tuple):
    """One scored candidate: the legacy cache tuple, plus objectives/metrics.

    Indexes exactly like the historical cache value
    ``(total, hw, acc_cost, accuracy, perf_cost)`` -- consumers written
    against ``cache[cfg][3]`` keep working -- and additionally carries the
    multi-objective vector (all-minimised) the NSGA-II strategy sorts on
    and any extended metrics (latency / energy / bandwidth congestion) the
    evaluator measured.
    """

    def __new__(cls, total, hw, acc_cost, accuracy, perf_cost=0.0, *, objectives=None, metrics=None):
        self = super().__new__(
            cls, (float(total), float(hw), float(acc_cost), float(accuracy), float(perf_cost))
        )
        if objectives is None:
            objectives = (1.0 - float(accuracy), float(hw))
        self.objectives = tuple(float(o) for o in objectives)
        self.metrics = dict(metrics or {})
        return self

    def __reduce__(self):
        return (_rebuild_eval_record, (tuple(self), self.objectives, self.metrics))

    @property
    def total(self):
        return self[0]

    @property
    def hw_cost(self):
        return self[1]

    @property
    def acc_cost(self):
        return self[2]

    @property
    def accuracy(self):
        return self[3]

    @property
    def perf_cost(self):
        return self[4]

    def to_json(self) -> dict:
        return {
            "total": self[0],
            "hw_cost": self[1],
            "acc_cost": self[2],
            "accuracy": self[3],
            "perf_cost": self[4],
            "objectives": list(self.objectives),
            "metrics": {k: float(v) for k, v in self.metrics.items()},
        }


@dataclasses.dataclass
class SearchResult:
    """Strategy-agnostic search outcome (the historical ``AnnealResult`` shape).

    ``cache`` maps cfg -> :class:`EvalRecord` (indexes like the legacy
    5-tuple); ``trace`` lists every scored candidate in evaluation order;
    ``front`` is the non-dominated subset of everything scored, in the
    strategy's objective space (scalarising strategies still report the
    default accuracy x hardware front).  ``requested_evaluations`` counts
    the proposals the search itself asked for -- the population annealer's
    speculative lane fill scores more.
    """

    best: tuple
    best_cost: float
    best_breakdown: dict
    evaluations: int
    trace: list[dict]  # every probed candidate: cfg, total/hw/acc/perf cost
    cache: dict  # cfg -> EvalRecord (total, hw, acc_cost, accuracy, perf_cost)
    requested_evaluations: int | None = None
    strategy: str = "anneal"
    front: list[dict] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        """Uniform JSON schema shared by every strategy's result."""
        return {
            "strategy": self.strategy,
            "best": list(self.best),
            "best_cost": self.best_cost,
            "best_breakdown": {k: v for k, v in self.best_breakdown.items()},
            "evaluations": self.evaluations,
            "requested_evaluations": self.requested_evaluations,
            "front": self.front,
            "trace": self.trace,
            "cache": [
                {"cfg": list(cfg), **rec.to_json()} for cfg, rec in self.cache.items()
            ],
        }


# ---------------------------------------------------------------------------
# Multi-objective primitives (all objectives minimised)
# ---------------------------------------------------------------------------


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Pareto dominance: a <= b everywhere with at least one strict."""
    at_least = all(x <= y for x, y in zip(a, b))
    return at_least and any(x < y for x, y in zip(a, b))


def non_dominated_sort(objs: Sequence[Sequence[float]]) -> list[list[int]]:
    """Fast-ish non-dominated sort -> fronts of indices (front 0 first)."""
    n = len(objs)
    dominated_by: list[list[int]] = [[] for _ in range(n)]
    dom_count = [0] * n
    fronts: list[list[int]] = [[]]
    for i in range(n):
        for j in range(i + 1, n):
            if dominates(objs[i], objs[j]):
                dominated_by[i].append(j)
                dom_count[j] += 1
            elif dominates(objs[j], objs[i]):
                dominated_by[j].append(i)
                dom_count[i] += 1
    for i in range(n):
        if dom_count[i] == 0:
            fronts[0].append(i)
    k = 0
    while fronts[k]:
        nxt: list[int] = []
        for i in fronts[k]:
            for j in dominated_by[i]:
                dom_count[j] -= 1
                if dom_count[j] == 0:
                    nxt.append(j)
        k += 1
        fronts.append(nxt)
    return [f for f in fronts if f]


def crowding_distance(objs: Sequence[Sequence[float]], front: Sequence[int]) -> dict[int, float]:
    """NSGA-II crowding distance of each index within one front."""
    dist = {i: 0.0 for i in front}
    if len(front) <= 2:
        return {i: math.inf for i in front}
    n_obj = len(objs[front[0]])
    for m in range(n_obj):
        order = sorted(front, key=lambda i: objs[i][m])
        lo, hi = objs[order[0]][m], objs[order[-1]][m]
        dist[order[0]] = dist[order[-1]] = math.inf
        span = hi - lo
        if span <= 0:
            continue
        for a, b, c in zip(order, order[1:], order[2:]):
            if dist[b] != math.inf:
                dist[b] += (objs[c][m] - objs[a][m]) / span
    return dist


# ---------------------------------------------------------------------------
# The strategy protocol
# ---------------------------------------------------------------------------


class SearchStrategy:
    """Base class / protocol for pluggable search strategies.

    Subclasses own their seeded RNG and schedule state; the search loop owns the
    evaluation cache.  ``propose`` may consult the cache (the population
    annealer's speculative fill scores unseen configurations in spare
    sweep lanes); ``observe`` reads the scored :class:`EvalRecord`s back
    out of it.  All randomness must flow through ``self.rng`` so
    ``state_dict`` snapshots are complete.
    """

    name = "base"

    def __init__(self, knobs: Mapping[str, Sequence], seed: int = 0):
        self.names, self.cfgs = enumerate_configs(knobs)
        self.knob_values = [list(v) for v in knobs.values()]
        self.rng = np.random.default_rng(seed)

    # -- the protocol -------------------------------------------------------
    def propose(self, cache: Mapping[tuple, EvalRecord]) -> list[tuple]:
        raise NotImplementedError

    def observe(self, cache: Mapping[tuple, EvalRecord]) -> None:
        raise NotImplementedError

    @property
    def finished(self) -> bool:
        raise NotImplementedError

    # -- resumability -------------------------------------------------------
    def state_dict(self) -> dict:
        """Complete JSON-serialisable state (subclasses extend)."""
        return {"rng": self.rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        self.rng = np.random.default_rng()
        self.rng.bit_generator.state = state["rng"]

    # -- result accounting --------------------------------------------------
    def requested_count(self, cache: Mapping[tuple, EvalRecord]) -> int:
        """How many evaluations the search itself asked for (see
        ``SearchResult.requested_evaluations``)."""
        return len(cache)

    def incumbent(self, cache: Mapping[tuple, EvalRecord]) -> tuple | None:
        """The strategy's own notion of the best candidate, or None to let
        the search loop take the cache-wide scalar minimum."""
        return None


# ---------------------------------------------------------------------------
# Simulated annealing (paper Listing 1), serial -- exact port of the
# historical ``simulated_annealing`` loop onto the protocol
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnnealConfig:
    t_start: float = 1.0
    t_min: float = 1e-3
    alpha: float = 0.85
    eval_divisor: int = 2  # the paper's k: probe |cfgs|/k neighbours per temp
    seed: int = 0


class AnnealStrategy(SearchStrategy):
    """Serial Metropolis annealer: one neighbour proposal per round.

    The RNG draw order is identical to the historical closed-loop
    implementation (neighbour draw in ``propose``, acceptance draw in
    ``observe`` only when the move is uphill), so a search driven through
    the protocol follows the exact trajectory the legacy
    ``simulated_annealing`` function produced.
    """

    name = "anneal"

    def __init__(self, knobs: Mapping[str, Sequence], config: AnnealConfig = AnnealConfig()):
        super().__init__(knobs, seed=config.seed)
        self.config = config
        self.n_per_temp = max(1, math.ceil(len(self.cfgs) / config.eval_divisor))
        self.T = config.t_start
        self.i_in_temp = 0
        self.cur: tuple | None = None
        self.cur_cost = math.inf
        self.best: tuple | None = None
        self.best_cost = math.inf
        self._pending: tuple | None = None
        self._started = False

    @property
    def finished(self) -> bool:
        return self._started and self.T <= self.config.t_min

    def propose(self, cache) -> list[tuple]:
        if not self._started:
            self.cur = self.cfgs[int(self.rng.integers(len(self.cfgs)))]
            self._pending = self.cur
        else:
            self._pending = neighbor(self.cur, self.knob_values, self.rng)
        return [self._pending]

    def observe(self, cache) -> None:
        ev = cache[self._pending]
        if not self._started:
            self.cur_cost = ev.total
            self.best, self.best_cost = self.cur, ev.total
            self._started = True
            return
        delta = ev.total - self.cur_cost
        if delta <= 0 or self.rng.random() <= math.exp(-delta / self.T):
            self.cur, self.cur_cost = self._pending, ev.total
            if self.cur_cost < self.best_cost:
                self.best, self.best_cost = self.cur, self.cur_cost
        self.i_in_temp += 1
        if self.i_in_temp >= self.n_per_temp:
            self.i_in_temp = 0
            self.T *= self.config.alpha

    def incumbent(self, cache) -> tuple | None:
        return self.best

    def state_dict(self) -> dict:
        return super().state_dict() | {
            "T": self.T,
            "i_in_temp": self.i_in_temp,
            "cur": list(self.cur) if self.cur is not None else None,
            "cur_cost": self.cur_cost,
            "best": list(self.best) if self.best is not None else None,
            "best_cost": self.best_cost,
            "started": self._started,
        }

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.T = state["T"]
        self.i_in_temp = state["i_in_temp"]
        self.cur = tuple(state["cur"]) if state["cur"] is not None else None
        self.cur_cost = state["cur_cost"]
        self.best = tuple(state["best"]) if state["best"] is not None else None
        self.best_cost = state["best_cost"]
        self._started = state["started"]
        self._pending = None


# ---------------------------------------------------------------------------
# Population-parallel annealing with speculative lane fill -- exact port of
# the historical ``simulated_annealing_population`` loop onto the protocol
# ---------------------------------------------------------------------------


class PopulationAnnealStrategy(SearchStrategy):
    """P walkers propose per round; spare sweep lanes fill speculatively.

    ``fill_width`` (default: ``population``) is the width the speculative
    fill targets -- a sharded evaluator sweeps ``ceil(width / n_devices)``
    candidates per device whatever the batch holds, so the explorer widens
    the fill to the device (x host) multiple and spare lanes score fresh
    candidates instead of shard padding.  The per-temperature proposal
    budget exactly matches the serial annealer, and the RNG draw order
    matches the legacy closed-loop implementation (walker/neighbour draws
    at round boundaries, fill permutation inside ``propose``, acceptance
    draws in ``observe``).
    """

    name = "anneal"

    def __init__(
        self,
        knobs: Mapping[str, Sequence],
        config: AnnealConfig = AnnealConfig(),
        population: int = 8,
        fill_width: int | None = None,
    ):
        if population < 1:
            raise ValueError(f"population must be >= 1, got {population}")
        super().__init__(knobs, seed=config.seed)
        self.config = config
        self.population = population
        self.fill_width = population if fill_width is None else max(fill_width, population)
        self.n_per_temp = max(1, math.ceil(len(self.cfgs) / config.eval_divisor))
        self.T = config.t_start
        self.proposed = 0
        self.walkers: list[tuple] | None = None
        self.costs: list[float] = []
        self.best: tuple | None = None
        self.best_cost = math.inf
        self._round: list[tuple] = []
        self._initialised = False
        self._finished = False
        self.requested: set[tuple] = set()

    @property
    def finished(self) -> bool:
        return self._finished

    def propose(self, cache) -> list[tuple]:
        if self.walkers is None:
            self.walkers = [
                self.cfgs[int(self.rng.integers(len(self.cfgs)))] for _ in range(self.population)
            ]
            self._round = list(self.walkers)
        batch = self._round
        self.requested.update(batch)
        fresh = [c for c in dict.fromkeys(batch) if c not in cache]
        if fresh and len(fresh) < self.fill_width:
            # speculative fill: score unseen candidates in the spare lanes
            seen = set(cache) | set(fresh)
            pool = [c for c in self.cfgs if c not in seen]
            order = self.rng.permutation(len(pool))[: self.fill_width - len(fresh)]
            fresh += [pool[i] for i in order]
        return fresh

    def observe(self, cache) -> None:
        if not self._initialised:
            self.costs = [cache[w].total for w in self.walkers]
            best_i = int(np.argmin(self.costs))
            self.best, self.best_cost = self.walkers[best_i], self.costs[best_i]
            self._initialised = True
            if self.T <= self.config.t_min:
                self._finished = True
            else:
                self._next_proposals()
            return
        for i, nbr in enumerate(self._round):
            delta = cache[nbr].total - self.costs[i]
            if delta <= 0 or self.rng.random() <= math.exp(-delta / self.T):
                self.walkers[i], self.costs[i] = nbr, cache[nbr].total
                if self.costs[i] < self.best_cost:
                    self.best, self.best_cost = nbr, self.costs[i]
        self.proposed += len(self._round)
        if self.proposed >= self.n_per_temp:
            self.proposed = 0
            self.T *= self.config.alpha
            if self.T <= self.config.t_min:
                self._finished = True
                return
        self._next_proposals()

    def _next_proposals(self) -> None:
        k = min(self.population, self.n_per_temp - self.proposed)
        self._round = [neighbor(self.walkers[i], self.knob_values, self.rng) for i in range(k)]

    def requested_count(self, cache) -> int:
        return len(self.requested)

    def incumbent(self, cache) -> tuple | None:
        return self.best

    def state_dict(self) -> dict:
        return super().state_dict() | {
            "T": self.T,
            "proposed": self.proposed,
            "walkers": [list(w) for w in self.walkers] if self.walkers is not None else None,
            "costs": list(self.costs),
            "best": list(self.best) if self.best is not None else None,
            "best_cost": self.best_cost,
            "round": [list(c) for c in self._round],
            "initialised": self._initialised,
            "finished": self._finished,
            "requested": sorted([list(c) for c in self.requested]),
        }

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.T = state["T"]
        self.proposed = state["proposed"]
        self.walkers = (
            [tuple(w) for w in state["walkers"]] if state["walkers"] is not None else None
        )
        self.costs = list(state["costs"])
        self.best = tuple(state["best"]) if state["best"] is not None else None
        self.best_cost = state["best_cost"]
        self._round = [tuple(c) for c in state["round"]]
        self._initialised = state["initialised"]
        self._finished = state["finished"]
        self.requested = {tuple(c) for c in state["requested"]}


# ---------------------------------------------------------------------------
# NSGA-II: multi-objective Pareto search with knob-aware variation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NSGAConfig:
    """NSGA-II schedule: ``population`` offspring per generation for
    ``generations`` rounds; binary tournaments on (rank, crowding);
    knob-aware variation (uniform per-knob crossover, adjacent-value
    mutation -- the same move the annealer's neighbour operator makes, so
    both searches walk the identical discrete lattice)."""

    population: int = 64
    generations: int = 12
    crossover_rate: float = 0.9
    mutation_rate: float | None = None  # default: 1 / n_knobs
    seed: int = 0


class NSGAStrategy(SearchStrategy):
    """Non-dominated sorting genetic search over the precision lattice.

    Objectives are whatever vector the evaluator attached to each
    :class:`EvalRecord` (all minimised): the explorer emits
    ``(1 - accuracy, hw_cost)`` by default and appends normalised latency,
    energy, and bandwidth-congestion terms when the perf cost is enabled --
    the four-axis accuracy x LUT/BRAM x latency x energy trade-off the
    fleet-scale DSE optimises.
    """

    name = "nsga2"

    def __init__(self, knobs: Mapping[str, Sequence], config: NSGAConfig = NSGAConfig()):
        if config.population < 2:
            raise ValueError(f"NSGA-II population must be >= 2, got {config.population}")
        super().__init__(knobs, seed=config.seed)
        self.config = config
        self.generation = 0
        self.parents: list[tuple] = []
        self._offspring: list[tuple] = self._initial_population()
        self._finished = False
        self.requested: set[tuple] = set()
        self.front_cfgs: list[tuple] = []

    def _initial_population(self) -> list[tuple]:
        n, pop = len(self.cfgs), self.config.population
        if n >= pop:
            idx = self.rng.choice(n, size=pop, replace=False)
        else:
            idx = self.rng.integers(n, size=pop)
        return [self.cfgs[int(i)] for i in idx]

    @property
    def finished(self) -> bool:
        return self._finished

    def propose(self, cache) -> list[tuple]:
        self.requested.update(self._offspring)
        return list(self._offspring)

    def observe(self, cache) -> None:
        pool = list(dict.fromkeys(self.parents + self._offspring))
        objs = [cache[c].objectives for c in pool]
        fronts = non_dominated_sort(objs)
        self.front_cfgs = [pool[i] for i in fronts[0]]
        ranks = {}
        for r, front in enumerate(fronts):
            for i in front:
                ranks[i] = r
        # environmental selection: whole fronts first, crowding on the cut
        chosen: list[int] = []
        for front in fronts:
            if len(chosen) + len(front) <= self.config.population:
                chosen.extend(front)
            else:
                crowd = crowding_distance(objs, front)
                by_crowd = sorted(front, key=lambda i: -crowd[i])
                chosen.extend(by_crowd[: self.config.population - len(chosen)])
                break
        self.parents = [pool[i] for i in chosen]
        crowd_all: dict[int, float] = {}
        for front in fronts:
            crowd_all.update(crowding_distance(objs, front))
        self.generation += 1
        if self.generation >= self.config.generations:
            self._finished = True
            return
        self._offspring = self._make_offspring(pool, ranks, crowd_all, chosen)

    def _make_offspring(self, pool, ranks, crowd, chosen) -> list[tuple]:
        cfg = self.config
        mut = cfg.mutation_rate if cfg.mutation_rate is not None else 1.0 / len(self.knob_values)

        def tournament() -> tuple:
            a, b = self.rng.integers(len(chosen), size=2)
            ia, ib = chosen[int(a)], chosen[int(b)]
            ka = (ranks[ia], -crowd.get(ia, 0.0))
            kb = (ranks[ib], -crowd.get(ib, 0.0))
            return pool[ia] if ka <= kb else pool[ib]

        offspring: list[tuple] = []
        while len(offspring) < cfg.population:
            p1, p2 = tournament(), tournament()
            if self.rng.random() < cfg.crossover_rate:
                child = tuple(
                    p1[i] if self.rng.random() < 0.5 else p2[i] for i in range(len(p1))
                )
            else:
                child = p1
            child = list(child)
            for i, vals in enumerate(self.knob_values):
                if len(vals) > 1 and self.rng.random() < mut:
                    # adjacent-value move, same lattice step as the annealer
                    j = vals.index(child[i])
                    if j == 0:
                        j2 = 1
                    elif j == len(vals) - 1:
                        j2 = j - 1
                    else:
                        j2 = j + int(self.rng.choice([-1, 1]))
                    child[i] = vals[j2]
            offspring.append(tuple(child))
        return offspring

    def requested_count(self, cache) -> int:
        return len(self.requested)

    def state_dict(self) -> dict:
        return super().state_dict() | {
            "generation": self.generation,
            "parents": [list(c) for c in self.parents],
            "offspring": [list(c) for c in self._offspring],
            "finished": self._finished,
            "requested": sorted([list(c) for c in self.requested]),
            "front": [list(c) for c in self.front_cfgs],
        }

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self.generation = state["generation"]
        self.parents = [tuple(c) for c in state["parents"]]
        self._offspring = [tuple(c) for c in state["offspring"]]
        self._finished = state["finished"]
        self.requested = {tuple(c) for c in state["requested"]}
        self.front_cfgs = [tuple(c) for c in state["front"]]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable] = {}


def register_strategy(name: str, factory: Callable) -> None:
    """Register ``factory(knobs, config=, population=, fill_width=) ->
    SearchStrategy`` under ``name`` (later wins, like a config)."""
    _REGISTRY[name] = factory


def available_strategies() -> list[str]:
    return sorted(_REGISTRY)


def make_strategy(
    name: str,
    knobs: Mapping[str, Sequence],
    config=None,
    population: int = 0,
    fill_width: int | None = None,
) -> SearchStrategy:
    """Build a registered strategy.  ``config`` is strategy-specific
    (:class:`AnnealConfig` / :class:`NSGAConfig`; None = defaults);
    ``population`` / ``fill_width`` parameterise population-capable
    strategies and are ignored by the rest."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown search strategy {name!r}; available: {available_strategies()}"
        ) from None
    return factory(knobs, config=config, population=population, fill_width=fill_width)


def _anneal_factory(knobs, config=None, population: int = 0, fill_width=None):
    config = AnnealConfig() if config is None else config
    if population and population > 1:
        return PopulationAnnealStrategy(knobs, config, population=population, fill_width=fill_width)
    return AnnealStrategy(knobs, config)


def _nsga_factory(knobs, config=None, population: int = 0, fill_width=None):
    if config is None:
        config = NSGAConfig(population=population) if population and population > 1 else NSGAConfig()
    return NSGAStrategy(knobs, config)


register_strategy("anneal", _anneal_factory)
register_strategy("nsga2", _nsga_factory)


# ---------------------------------------------------------------------------
# The strategy-agnostic search loop
# ---------------------------------------------------------------------------

_SNAPSHOT_VERSION = 1


def _snapshot(checkpointer, round_no, strategy, cache, trace) -> None:
    import numpy as _np

    state = {
        "version": _SNAPSHOT_VERSION,
        "strategy": strategy.name,
        "round": round_no,
        "strategy_state": strategy.state_dict(),
        "cache": [
            {"cfg": list(cfg), **rec.to_json()} for cfg, rec in cache.items()
        ],
        "trace": trace,
    }
    checkpointer.save(round_no, {"round": _np.int64(round_no)}, user_state=state, blocking=True)


def _restore(checkpointer, strategy) -> tuple[dict, list, int] | None:
    import numpy as _np

    from repro_torch.checkpoint.checkpointer import latest_step

    if latest_step(checkpointer.root) is None:
        return None
    _, state = checkpointer.restore({"round": _np.int64(0)})
    if state.get("version") != _SNAPSHOT_VERSION or state.get("strategy") != strategy.name:
        raise ValueError(
            f"search snapshot under {checkpointer.root} was written by strategy "
            f"{state.get('strategy')!r} v{state.get('version')}; refusing to resume "
            f"{strategy.name!r} from it"
        )
    cache = {}
    for ent in state["cache"]:
        cache[tuple(ent["cfg"])] = EvalRecord(
            ent["total"], ent["hw_cost"], ent["acc_cost"], ent["accuracy"], ent["perf_cost"],
            objectives=ent["objectives"], metrics=ent["metrics"],
        )
    strategy.load_state_dict(state["strategy_state"])
    return cache, list(state["trace"]), int(state["round"])


def run_search(
    strategy: SearchStrategy,
    knobs: Mapping[str, Sequence],
    hw_cost_fn: Callable[[tuple], float],
    batch_acc_fn: Callable[[list], Sequence[float]],
    acc_cost_fn: Callable[[float], float],
    extra_cost_fn: Callable[[tuple], float] | None = None,
    metrics_fn: Callable[[tuple], dict] | None = None,
    objectives_fn: Callable[[tuple, EvalRecord], Sequence[float]] | None = None,
    checkpointer=None,
    snapshot_every: int = 1,
    max_evaluations: int | None = None,
    max_rounds: int | None = None,
    resume: bool = True,
) -> SearchResult:
    """Drive ``strategy`` to completion over the knob space.

    The search loop pre-computes every candidate's hardware cost (cheap, pure
    host arithmetic -- the paper's lines 8-13), then loops
    propose -> score-fresh -> observe.  ``batch_acc_fn`` scores a list of
    *uncached* configurations in one call (the explorer backs it with the
    population sweep ``eval_int_population``, or a serial per-candidate
    evaluator for width-1 strategies); ``extra_cost_fn``/``metrics_fn``
    add the event-aware perf cost and its extended metrics, evaluated
    after the accuracy term like the legacy annealer did;
    ``objectives_fn(cfg, record)`` supplies the multi-objective vector
    (default: ``(1 - accuracy, hw_cost)``).

    ``checkpointer`` (a ``repro_torch.checkpoint.Checkpointer``) snapshots the
    complete search state -- cache, trace, and the strategy's
    ``state_dict`` including its RNG -- after every ``snapshot_every``
    completed rounds, and an existing snapshot is resumed from
    automatically (``resume=False`` ignores it).  Evaluation is pure in
    the configuration, so a resumed search replays the exact trajectory
    of an uninterrupted one: fresh work since the last snapshot is simply
    recomputed, bit-identically.

    ``max_evaluations`` stops the search once the cache holds that many
    scored candidates (the equal-budget lever the DSE benchmark uses);
    ``max_rounds`` bounds the number of propose/observe rounds this call
    runs (a cooperative "kill" for tests and partial runs) -- both return
    a valid partial :class:`SearchResult`.
    """
    names, cfgs = enumerate_configs(knobs)
    hw_cache = {cfg: float(hw_cost_fn(cfg)) for cfg in cfgs}
    cache: dict[tuple, EvalRecord] = {}
    trace: list[dict] = []
    round_no = 0
    if checkpointer is not None and resume:
        restored = _restore(checkpointer, strategy)
        if restored is not None:
            cache, trace, round_no = restored

    def score(fresh: list[tuple]) -> None:
        accs = batch_acc_fn(fresh)
        for cfg, accuracy in zip(fresh, accs):
            accuracy = float(accuracy)
            a_cost = float(acc_cost_fn(accuracy))
            p_cost = float(extra_cost_fn(cfg)) if extra_cost_fn is not None else 0.0
            metrics = metrics_fn(cfg) if metrics_fn is not None else {}
            total = hw_cache[cfg] + a_cost + p_cost
            rec = EvalRecord(
                total, hw_cache[cfg], a_cost, accuracy, p_cost, metrics=metrics
            )
            if objectives_fn is not None:
                rec = EvalRecord(
                    total, hw_cache[cfg], a_cost, accuracy, p_cost,
                    objectives=objectives_fn(cfg, rec), metrics=metrics,
                )
            cache[cfg] = rec
            trace.append(
                dict(
                    cfg=dict(zip(names, cfg)), total=total, hw=hw_cache[cfg],
                    acc_cost=a_cost, accuracy=accuracy, perf_cost=p_cost,
                    **{k: float(v) for k, v in metrics.items()},
                )
            )

    rounds_this_call = 0
    while not strategy.finished:
        if max_rounds is not None and rounds_this_call >= max_rounds:
            break
        batch = strategy.propose(cache)
        fresh = [c for c in dict.fromkeys(batch) if c not in cache]
        if fresh:
            score(fresh)
        strategy.observe(cache)
        round_no += 1
        rounds_this_call += 1
        if checkpointer is not None and snapshot_every and round_no % snapshot_every == 0:
            _snapshot(checkpointer, round_no, strategy, cache, trace)
        if max_evaluations is not None and len(cache) >= max_evaluations:
            break
    if checkpointer is not None and strategy.finished:
        _snapshot(checkpointer, round_no, strategy, cache, trace)

    best = strategy.incumbent(cache)
    if best is None or best not in cache:
        best = min(cache, key=lambda c: cache[c].total)
    rec = cache[best]
    return SearchResult(
        best=best,
        best_cost=rec.total,
        best_breakdown=dict(zip(names, best))
        | {
            "hw_cost": rec.hw_cost,
            "acc_cost": rec.acc_cost,
            "accuracy": rec.accuracy,
            "perf_cost": rec.perf_cost,
        },
        evaluations=len(cache),
        trace=trace,
        cache=cache,
        requested_evaluations=strategy.requested_count(cache),
        strategy=strategy.name,
        front=_front(names, cache),
    )


def _front(names, cache: Mapping[tuple, EvalRecord]) -> list[dict]:
    """Non-dominated subset of everything scored, in objective space."""
    cfgs = list(cache)
    if not cfgs:
        return []
    objs = [cache[c].objectives for c in cfgs]
    first = non_dominated_sort(objs)[0]
    pts = [
        {
            "cfg": dict(zip(names, cfgs[i])),
            "hw_cost": cache[cfgs[i]].hw_cost,
            "accuracy": cache[cfgs[i]].accuracy,
            "total": cache[cfgs[i]].total,
            "objectives": list(cache[cfgs[i]].objectives),
        }
        for i in first
    ]
    return sorted(pts, key=lambda p: (p["hw_cost"], -p["accuracy"]))
