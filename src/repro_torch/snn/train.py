"""Evaluation of deployed Flexi-NeurA networks (port of ``repro/snn/train.py``).

Ports :func:`eval_int`, the bit-exact hardware-faithful accuracy the DSE
and the deployment path use, and :func:`eval_int_population`, which scores a
whole population of precision candidates per data batch (the population DSE
sweep).  BPTT training and ``eval_float`` wait for a later slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core.backend import _batch_mean
from repro_torch.core.network import NetworkConfig, run_int
from repro_torch.data.snn_datasets import SpikeDataset, raster_tensor

__all__ = ["eval_int", "eval_int_population"]


def eval_int(
    net,
    qparams,
    ds: SpikeDataset,
    batch_size: int = 256,
    return_stats: bool = False,
    backend="reference",
    mesh=None,
):
    """Bit-exact hardware-faithful accuracy on the parameters' device.

    With ``return_stats``, also returns per-layer mean events per step and
    input events per step (the latency/energy model inputs, see
    ``hw_model.EventTraffic``).  Every registered backend is bit-exact, so
    ``backend`` is a speed knob, not an accuracy knob.  ``mesh`` must be
    None: multi-device evaluation waits for a later slice.
    """
    if mesh is not None:
        raise NotImplementedError("eval_int: mesh sharding is not ported yet (mesh=None)")
    resolved = backend_lib.get_backend(backend)
    device = qparams[0].w_ff.device

    correct = total = 0
    layer_ev = None
    in_ev = None
    for spikes, labels in ds.batches(batch_size):
        rec = run_int(net, qparams, raster_tensor(spikes, device), backend=resolved)
        stats = rec.event_stats()
        correct += int((rec.predictions().cpu().numpy() == labels).sum())
        n = len(labels)
        total += n
        # weight each batch's per-sample mean by its size so a partial
        # final batch doesn't bias the dataset-level event traffic
        evs = [e * n for e in stats["layer_events_per_step"]]
        iev = stats["input_events_per_step"] * n
        layer_ev = evs if layer_ev is None else [a + b for a, b in zip(layer_ev, evs)]
        in_ev = iev if in_ev is None else in_ev + iev
    acc = correct / max(1, total)
    if not return_stats:
        return acc
    layer_ev = [e / max(1, total) for e in layer_ev]
    in_ev = in_ev / max(1, total)
    return acc, {"input_events_per_step": np.asarray(in_ev), "layer_events_per_step": layer_ev}


def _population_fwd(net, stacked_qparams, beta_regs, alpha_regs, spikes):
    """One data batch of the sweep: [P, batch] predictions, [P, T, L]
    batch-mean emitted events and [T] batch-mean input events (numpy
    float32, as JAX's ``jnp.mean`` computes them: ``sum * fl32(1/batch)``)."""
    counts, emitted = backend_lib.run_int_population(
        net, stacked_qparams, beta_regs, alpha_regs, spikes, return_events=True
    )
    P, T, L, B = emitted.shape
    evs = _batch_mean(emitted.reshape(P * T * L, B)).reshape(P, T, L)
    iev = _batch_mean(backend_lib._count(spikes != 0))
    return torch.argmax(counts, dim=-1).cpu().numpy(), evs, iev


def eval_int_population(
    net,
    candidate_nets: Sequence[NetworkConfig],
    qparams_list: Sequence[list],
    ds: SpikeDataset,
    batch_size: int = 256,
    return_stats: bool = False,
    mesh=None,
):
    """Bit-exact accuracies for a population of precision candidates at once.

    All candidates share ``net``'s static structure (the DSE varies only
    quantized values and CG decay registers), so one sweep
    (:func:`~repro_torch.core.backend.run_int_population`) scores the whole
    population per data batch, on the parameters' device.

    Returns a float accuracy per candidate (numpy float64), identical to
    calling :func:`eval_int` per candidate.  With ``return_stats``, also one
    per-candidate event-traffic dict of the same shape as ``eval_int(...,
    return_stats=True)`` (numpy float32, bit-identical to JAX's sweep) --
    each candidate quantizes differently and therefore spikes differently,
    which is what the event-aware DSE cost needs to see.  ``mesh`` must be
    None: multi-device sweeps wait for a later slice.
    """
    if mesh is not None:
        raise NotImplementedError(
            "eval_int_population: mesh sharding is not ported yet (mesh=None)"
        )
    backend_lib.check_population_structure(net, candidate_nets)
    stacked, beta_regs, alpha_regs = backend_lib.stack_population(candidate_nets, qparams_list)
    device = beta_regs.device

    P = len(candidate_nets)
    correct = np.zeros(P, np.int64)
    total = 0
    layer_ev = None  # [P, T, L] running size-weighted sum of batch means
    in_ev = None  # [T]
    for spikes, labels in ds.batches(batch_size):
        preds, evs, iev = _population_fwd(
            net, stacked, beta_regs, alpha_regs, raster_tensor(spikes, device)
        )
        correct += (preds == labels[None, :]).sum(axis=1)
        n = len(labels)
        total += n
        # size-weighted like eval_int: partial batches must not bias traffic
        evs, iev = evs * n, iev * n
        layer_ev = evs if layer_ev is None else layer_ev + evs
        in_ev = iev if in_ev is None else in_ev + iev
    accs = correct / max(1, total)
    if not return_stats:
        return accs
    layer_ev = layer_ev / max(1, total)
    in_ev = in_ev / max(1, total)
    stats = [
        {
            "input_events_per_step": in_ev,
            "layer_events_per_step": [layer_ev[p, :, l] for l in range(layer_ev.shape[2])],
        }
        for p in range(P)
    ]
    return accs, stats
