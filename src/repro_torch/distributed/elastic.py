"""Elastic scaling and straggler mitigation (control-plane logic).

Port of ``repro/distributed/elastic.py``: pure Python, copied as it is, so
plans and monitor actions equal JAX's.  Checkpoints are host numpy and
mesh-agnostic, so the data plane of a replan is a restore onto the new
devices.  This module holds the decisions around it, written as pure,
unit-testable logic:

* :class:`ElasticPlan` -- given old/new chip counts, recompute the mesh,
  per-shard batch, and whether optimizer state can be carried (always true
  here: state reshards with the same specs as params).
* :class:`StragglerMonitor` -- deadline-based detection over step-time
  telemetry (median x tolerance), with the standard mitigations ranked:
  within-step work-stealing is impossible under SPMD, so the actions are
  (1) flag and exclude the host from the next data reshuffle, (2) swap in a
  spare (checkpoint restore on the replacement), (3) shrink the mesh
  (elastic replan).
"""

from __future__ import annotations

import dataclasses
import statistics

__all__ = ["ElasticPlan", "plan_elastic_restart", "StragglerMonitor"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_chips: int
    new_chips: int
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    per_shard_batch: int
    grad_accum_steps: int
    notes: str

    @property
    def keeps_global_batch(self) -> bool:
        return True


def plan_elastic_restart(
    *,
    old_chips: int,
    new_chips: int,
    global_batch: int,
    model_parallel: int = 16,
    pod_size: int = 256,
) -> ElasticPlan:
    """Recompute the mesh after losing/gaining capacity.

    Strategy: hold TP (model axis) fixed -- it is baked into the layer
    shardings and kernel tilings -- and absorb the chip delta on the data
    axis, holding the *global* batch constant via gradient accumulation
    when the new data extent doesn't divide it.
    """
    if new_chips % model_parallel:
        raise ValueError(f"new chip count {new_chips} must keep TP={model_parallel}")
    pods, rem = divmod(new_chips, pod_size)
    if pods >= 2 and rem == 0:
        shape = (pods, pod_size // model_parallel, model_parallel)
        axes = ("pod", "data", "model")
        data_extent = pods * shape[1]
    else:
        shape = (new_chips // model_parallel, model_parallel)
        axes = ("data", "model")
        data_extent = shape[0]
    # smallest accumulation factor that factors the global batch exactly over
    # the new data extent; falls back to ceil-rounding (batch drifts by <1
    # microbatch per shard, logged in notes) if nothing divides.
    per, accum = None, 1
    for a in range(1, 65):
        if global_batch % (data_extent * a) == 0:
            per, accum = global_batch // (data_extent * a), a
            break
    if per is None:
        accum = 1
        per = max(1, round(global_batch / data_extent))
    return ElasticPlan(
        old_chips=old_chips,
        new_chips=new_chips,
        mesh_shape=shape,
        mesh_axes=axes,
        per_shard_batch=per,
        grad_accum_steps=accum,
        notes=f"TP held at {model_parallel}; data axis {data_extent}; restore via Checkpointer.restore(shardings=new_mesh_specs)",
    )


@dataclasses.dataclass
class StragglerMonitor:
    tolerance: float = 1.5  # step slower than median x tolerance => straggler
    window: int = 32
    min_samples: int = 8

    def __post_init__(self):
        self._times: list[float] = []
        self.flagged_steps: list[int] = []

    def observe(self, step: int, seconds: float) -> str | None:
        """Record a step time; returns a mitigation action or None."""
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < self.min_samples:
            return None
        med = statistics.median(self._times[:-1])
        if seconds > self.tolerance * med:
            self.flagged_steps.append(step)
            recent = [s for s in self.flagged_steps if s > step - self.window]
            if len(recent) >= 5:
                return "replace"  # persistent: swap in spare, restore checkpoint
            return "flag"  # transient: note and continue
        return None
