"""Evaluation of deployed Flexi-NeurA networks (port of ``repro/snn/train.py``).

This slice ports :func:`eval_int`, the bit-exact hardware-faithful accuracy
the DSE and the deployment path use.  BPTT training, ``eval_float`` and the
population evaluation wait for later slices.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import backend as backend_lib
from repro_torch.core.network import run_int
from repro_torch.data.snn_datasets import SpikeDataset, raster_tensor

__all__ = ["eval_int"]


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
