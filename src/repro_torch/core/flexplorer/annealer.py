"""Simulated annealing over a discrete configuration space (paper Listing 1).

Faithful to the paper's procedure:

* enumerate all candidates consistent with the user's bounds up front,
* pre-compute and cache the hardware cost of every candidate,
* anneal: from a random start, probe ``|cfgs| / k`` neighbours per
  temperature (k = user's "evaluation divisor"), where a neighbour changes
  exactly one knob to an adjacent value,
* accept better moves always, worse moves with probability exp(-delta/T),
* geometric cooling T <- alpha * T until T_min; return the incumbent best.

Accuracy evaluations are cached (they dominate runtime -- the paper
JIT-compiles them with Numba; here they run on the card through the
``spike_matmul`` / ``lif_scan`` kernels).

The annealer is generic: knobs are named tuples of discrete values, and the
caller supplies ``hw_cost_fn(cfg)`` and ``acc_fn(cfg)`` callbacks, so the
same machinery drives both the SNN precision search and the LM-scale
precision/roofline search.

Since the strategy redesign the annealing logic itself lives in
:mod:`repro_torch.core.flexplorer.strategies` as :class:`AnnealStrategy` /
:class:`PopulationAnnealStrategy` -- two implementations of the pluggable
``SearchStrategy`` protocol, driven by the strategy-agnostic
:func:`~repro_torch.core.flexplorer.strategies.run_search` loop.  The functions
here are the stable legacy entry points: they build the strategy, run the
search loop, and return the same result (bit-identical trajectory: the RNG draw
order of the closed-loop implementations is preserved exactly).
``AnnealResult`` is now an alias of the strategy-agnostic
:class:`~repro_torch.core.flexplorer.strategies.SearchResult` -- same field
layout, so artifacts and imports from earlier PRs keep working.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

from repro_torch.core.flexplorer.strategies import (
    AnnealConfig,
    AnnealStrategy,
    PopulationAnnealStrategy,
    SearchResult,
    enumerate_configs,
    neighbor as _neighbor,
    run_search,
)

__all__ = [
    "AnnealConfig",
    "AnnealResult",
    "enumerate_configs",
    "simulated_annealing",
    "simulated_annealing_population",
]

# Legacy alias: the annealer-shaped result is the uniform SearchResult.
AnnealResult = SearchResult


def simulated_annealing(
    knobs: Mapping[str, Sequence],
    hw_cost_fn: Callable[[tuple], float],
    acc_fn: Callable[[tuple], float],
    acc_cost_fn: Callable[[float], float],
    anneal: AnnealConfig = AnnealConfig(),
    extra_cost_fn: Callable[[tuple], float] | None = None,
    checkpointer=None,
    snapshot_every: int = 1,
) -> AnnealResult:
    """``extra_cost_fn`` (optional) adds a per-candidate cost term evaluated
    *after* ``acc_fn`` for the same candidate -- the explorer uses it for the
    event-aware latency/energy cost, which reuses the simulation traffic the
    accuracy evaluation just measured.  ``checkpointer`` (optional, a
    ``repro_torch.checkpoint.Checkpointer``) makes the search resumable; see
    :func:`~repro_torch.core.flexplorer.strategies.run_search`."""
    strategy = AnnealStrategy(knobs, anneal)
    return run_search(
        strategy,
        knobs,
        hw_cost_fn,
        batch_acc_fn=lambda batch: [float(acc_fn(c)) for c in batch],
        acc_cost_fn=acc_cost_fn,
        extra_cost_fn=extra_cost_fn,
        checkpointer=checkpointer,
        snapshot_every=snapshot_every,
    )


def simulated_annealing_population(
    knobs: Mapping[str, Sequence],
    hw_cost_fn: Callable[[tuple], float],
    batch_acc_fn: Callable[[list[tuple]], Sequence[float]],
    acc_cost_fn: Callable[[float], float],
    anneal: AnnealConfig = AnnealConfig(),
    population: int = 8,
    extra_cost_fn: Callable[[tuple], float] | None = None,
    fill_width: int | None = None,
    checkpointer=None,
    snapshot_every: int = 1,
) -> AnnealResult:
    """Population-parallel annealing: propose/accept per population step.

    ``population`` independent walkers each propose one neighbour per step;
    all uncached proposals of the step are scored through a *single*
    ``batch_acc_fn`` call (the explorer backs this with one population
    sweep, ``eval_int_population``), then every walker accepts/rejects against its own
    incumbent with the usual Metropolis rule.  The per-temperature proposal
    budget *exactly* matches the serial annealer (``ceil(|cfgs| /
    eval_divisor)`` proposals per temperature, split across walkers; a
    partial final round uses only the first walkers), so the two modes run
    the same search schedule -- population mode just amortises the
    simulator's compile-and-run over whole proposal batches.

    A width-P sweep costs the same no matter how many of its lanes carry
    fresh candidates, so spare lanes are filled *speculatively* with
    not-yet-scored configurations instead of padding: the cache warms at
    full sweep width and late-temperature steps run entirely from cache.
    (The paper's own annealer pre-computes every candidate's hardware cost
    up front; this extends the same idea to the expensive accuracy term,
    adaptively.)

    ``fill_width`` (default: ``population``) is the width the speculative
    fill targets.  A sharded evaluator sweeps ``ceil(width / n_devices)``
    candidates per device whatever the batch holds, so the explorer widens
    the fill to the device multiple -- spare device lanes then score fresh
    candidates instead of shard padding.

    Returns the same :class:`AnnealResult` shape as
    :func:`simulated_annealing` (best incumbent across all walkers).
    """
    strategy = PopulationAnnealStrategy(
        knobs, anneal, population=population, fill_width=fill_width
    )
    return run_search(
        strategy,
        knobs,
        hw_cost_fn,
        batch_acc_fn=batch_acc_fn,
        acc_cost_fn=acc_cost_fn,
        extra_cost_fn=extra_cost_fn,
        checkpointer=checkpointer,
        snapshot_every=snapshot_every,
    )
