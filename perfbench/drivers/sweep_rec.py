"""Traffic kind ``sweep_rec``: the population sweep of ``sweep`` on a net with
a dense recurrent (ATA-T) core.

As ``sweep`` in every step, with three differences.  Each ATA-T layer's
float ``w_rec`` [n_out, n_out] is drawn uniform(+-1/sqrt(n_out)), as the
port's ``init_float_params`` lays it out, from a stream of the seed of its
own, and the candidates are quantized with it.  The plan of kernel launches
and the operations of a unit count the recurrence: T ``spike_matmul``
launches per ATA-T layer and sweep, [P, B, N] @ [P, N, N], and 2 T N**2
operations per sample.  The answers are held to ``reference_rec.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import data, program, reference, reference_rec, work
from perfbench.drivers import sweep
from repro_torch.core.network import quantize_params

UNIT = sweep.UNIT
REC_STREAM = 14  # the seed's stream of the recurrent matrices


def recurrent_weights(seed: int, layers: list[dict], device) -> list[torch.Tensor]:
    """Per ATA-T layer, in order, its float32 ``w_rec`` [n_out, n_out]."""
    gen = data.generator(seed, REC_STREAM, device)
    out = []
    for layer in layers:
        if layer["topology"] == "ata_t":
            n = layer["n_out"]
            lim = 1.0 / math.sqrt(n)
            out.append(torch.rand((n, n), generator=gen, device=device) * (2 * lim) - lim)
    return out


class Driver(sweep.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        rec = iter(recurrent_weights(seed, self.layers, device))
        self.weights = [
            (w_ff, next(rec) if layer["topology"] == "ata_t" else w_rec, theta)
            for layer, (w_ff, w_rec, theta) in zip(self.layers, self.weights)
        ]
        params = program.float_params(self.weights)
        self.qps = [quantize_params(c, params)[0] for c in self.cands]
        self.rec_layers = [layer for layer in self.layers if layer["topology"] == "ata_t"]

    def ops_per_unit(self) -> float:
        rec = sum(2 * self.T * layer["n_out"] ** 2 for layer in self.rec_layers)
        return super().ops_per_unit() + self.traffic["samples"] * rec

    def launches(self, first: int, last: int) -> dict[str, list[tuple[int, int]]]:
        out = super().launches(first, last)
        B = len(self.ds.labels)
        for draw, _, _ in self.done[first:last]:
            for layer in self.rec_layers:
                N = layer["n_out"]
                out["spike_matmul_kernel"] += [work.spike_matmul_work(len(draw), B, N, N, False)] * self.T
        return out

    def truth(self, draw: np.ndarray, precision_drop: int = 0) -> reference.Truth:
        """The reference's answer for the candidates of ``draw``, in blocks."""
        block = self.traffic["ref_candidates"]
        parts = []
        for lo in range(0, len(draw), block):
            cands = [self.space[i] for i in draw[lo : lo + block]]
            qs = reference_rec.quantize(self.layers, self.weights, cands, precision_drop)
            parts.append(
                reference_rec.evaluate(
                    self.layers, qs, self.ds.spikes, self.ds.labels, self.device, len(self.ds.labels)
                )
            )
        return reference.Truth(
            correct=np.concatenate([p.correct for p in parts]),
            emitted=np.concatenate([p.emitted for p in parts]),
            input_events=parts[0].input_events,
            n=parts[0].n,
        )
