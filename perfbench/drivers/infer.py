"""Traffic kind ``infer``: batch inference through the event backend, one pass
over a test set a call.

Set-up quantizes the configuration once (its stated ``w_bits`` / ``leak_bits``,
a deployment) and draws ``datasets`` distinct test sets of ``samples`` samples
each; call i classifies set ``i % datasets`` with ``eval_int(...,
return_stats=True)`` in batches of ``batch`` through ``EventBackend(strategy=
"pallas")``: the host raster copied to the card, the AER encoder and
``sparse_accum`` for each sparse layer, the step loop after them.  A call's
unit is a sample.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from perfbench import data, program, reference, work
from repro_torch.core.backend import EventBackend
from repro_torch.core.network import quantize_params
from repro_torch.data.snn_datasets import SpikeDataset
from repro_torch.snn.train import eval_int

UNIT = "samples"


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.layers = config["network"]["layers"]
        self.T = config["network"]["n_steps"]
        self.net = program.network(config)
        self.sets = []
        for r in range(traffic["datasets"]):
            spikes, labels = data.heldout_rasters(
                seed, 1 + r, traffic["samples"], self.T, config["inputs"]["max_rate"], device
            )
            self.sets.append(SpikeDataset(spikes, labels, 10, f"{config['name']}:test{r}"))
        self.weights = data.float_weights(seed, self.layers, device)
        self.qparams = quantize_params(self.net, program.float_params(self.weights))[0]
        self.backend = EventBackend(strategy=traffic["event_strategy"])
        self.evaluate = self._program
        self.done: list[tuple[int, float, dict]] = []  # (set, accuracy, stats)
        self.sparse: dict[int, list] = {}  # set -> (rows, events, n_in, N) per sparse launch

    def ops_per_unit(self) -> float:
        return work.net_ops_per_sample(self.layers, self.T)

    def _program(self, r: int):
        return eval_int(
            self.net,
            self.qparams,
            self.sets[r],
            batch_size=self.traffic["batch"],
            return_stats=True,
            backend=self.backend,
        )

    def warmup(self) -> None:
        self._program(0)

    def call(self) -> int:
        r = len(self.done) % len(self.sets)
        acc, stats = self.evaluate(r)
        self.done.append((r, acc, stats))
        return len(self.sets[r].labels)

    def truth(self, r: int, precision_drop: int = 0) -> reference.Truth:
        """The reference over set ``r``, block by block as the program batches
        it; notes each block's sparse launches (by the event path's frozen
        budget rule) for the roofline of ``sparse_accum``."""
        cfg = self.layers[0]
        qs = reference.quantize(
            self.layers, self.weights, [(cfg["w_bits"], cfg["w_rec_bits"], cfg["leak_bits"])],
            precision_drop,
        )
        launches = []

        def on_block(res, lo, hi):
            for layer, x in zip(self.layers, res.inputs):
                active = x.sum(dim=-1)  # [1, T, B]
                if work.takes_sparse_path(int(active.max()), layer["n_in"]):
                    rows = active.numel()
                    launches.append((rows, int(active.sum()), layer["n_in"], layer["n_out"]))

        ds = self.sets[r]
        truth = reference.evaluate(
            self.layers, qs, ds.spikes, ds.labels, self.device, self.traffic["batch"], on_block
        )
        if not precision_drop:
            self.sparse[r] = launches
        return truth

    def launches(self, first: int, last: int) -> dict[str, list[tuple[int, int]]]:
        out = {"sparse_accum_kernel": []}
        for r, _, _ in self.done[first:last]:
            out["sparse_accum_kernel"] += [work.sparse_accum_work(*l) for l in self.sparse[r]]
        return out

    def control(self, r: int):
        accs, stats = reference.as_program_output(self.truth(r, precision_drop=1))
        return float(accs[0]), stats[0]

    def check(self) -> tuple[dict, int]:
        """Gaps of every call, each against the reference of its set, and the
        calls found wrong."""
        truths = {r: self.truth(r) for r in sorted({r for r, _, _ in self.done})}
        acc_gap, ev_gap, failed = 0, 0.0, 0
        lim = self.traffic["limits"]
        for r, acc, stats in self.done:
            a, e = reference.gaps(np.array([acc]), [stats], truths[r])
            acc_gap, ev_gap = max(acc_gap, a), max(ev_gap, e)
            failed += int(a > lim["acc_gap"] or e > lim["event_gap"])
        for r, launches in sorted(self.sparse.items()):
            layers = [n_in for _, _, n_in, _ in launches]
            print(f"infer: set {r}: sparse_accum launches by layer width {layers}", file=sys.stderr)
        return {"acc_gap": acc_gap, "event_gap": ev_gap}, failed

    def free(self) -> None:
        self.qparams = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
