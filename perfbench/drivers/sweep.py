"""Traffic kind ``sweep``: the Flex-plorer's population sweep, one sweep a call.

Set-up quantizes the traffic's part of the configuration's space once, as the
explorer's ``qp_cache`` keeps every candidate once proposed.  Each call draws
``population`` distinct candidates from the seed (the whole space, in a new
order, where ``population`` is null), stacks them and scores them over the
held-out samples with ``eval_int_population(..., return_stats=True)``, as
``explore_snn`` does with an event-aware cost.  A call's unit is a candidate.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import data, program, reference, work
from repro_torch.core.network import quantize_params
from repro_torch.snn.train import eval_int_population
from repro_torch.data.snn_datasets import SpikeDataset

UNIT = "candidates"


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.layers = config["network"]["layers"]
        self.T = config["network"]["n_steps"]
        self.net = program.network(config)
        n = traffic["samples"]
        spikes, labels = data.heldout_rasters(
            seed, 0, n, self.T, config["inputs"]["max_rate"], device
        )
        self.ds = SpikeDataset(spikes, labels, 10, config["name"] + ":heldout")
        self.weights = data.float_weights(seed, self.layers, device)
        params = program.float_params(self.weights)
        self.space = program.space(config, traffic.get("max_bits"))
        self.cands = [program.candidate(self.net, c) for c in self.space]
        self.qps = [quantize_params(c, params)[0] for c in self.cands]
        self.P = traffic["population"] or len(self.space)
        self.rng = np.random.default_rng(seed)
        self.evaluate = self._program
        self.done: list[tuple[np.ndarray, np.ndarray, list]] = []  # (draw, accs, stats)

    def ops_per_unit(self) -> float:
        return self.traffic["samples"] * work.net_ops_per_sample(self.layers, self.T)

    def _draw(self) -> np.ndarray:
        if self.P == len(self.space):
            return self.rng.permutation(len(self.space))
        return self.rng.choice(len(self.space), self.P, replace=False)

    def _program(self, draw: np.ndarray):
        return eval_int_population(
            self.net,
            [self.cands[i] for i in draw],
            [self.qps[i] for i in draw],
            self.ds,
            batch_size=len(self.ds.labels),
            return_stats=True,
        )

    def warmup(self) -> None:
        self._program(self._draw())

    def call(self) -> int:
        draw = self._draw()
        accs, stats = self.evaluate(draw)
        self.done.append((draw, accs, stats))
        return len(draw)

    def launches(self, first: int, last: int) -> dict[str, list[tuple[int, int]]]:
        """(bytes, operations) of every kernel launch of calls [first, last)."""
        M = self.T * len(self.ds.labels)
        out = {"spike_matmul_kernel": [], "lif_scan_kernel": []}
        for draw, _, _ in self.done[first:last]:
            P = len(draw)
            for li, layer in enumerate(self.layers):
                K, N = layer["n_in"], layer["n_out"]
                out["spike_matmul_kernel"].append(work.spike_matmul_work(P, M, K, N, li == 0))
                if layer["topology"] == "ff":
                    taps = sum(
                        bin(k).count("1")
                        for k in (
                            reference.decay_register(layer["beta"], self.space[i][2]) for i in draw
                        )
                        if k < 256
                    )
                    B = len(self.ds.labels)
                    out["lif_scan_kernel"].append(work.lif_scan_work(P, self.T, B, N, taps))
        return out

    def truth(self, draw: np.ndarray, precision_drop: int = 0) -> reference.Truth:
        """The reference's answer for the candidates of ``draw``, in blocks."""
        block = self.traffic["ref_candidates"]
        parts = []
        for lo in range(0, len(draw), block):
            cands = [self.space[i] for i in draw[lo : lo + block]]
            qs = reference.quantize(self.layers, self.weights, cands, precision_drop)
            parts.append(
                reference.evaluate(
                    self.layers, qs, self.ds.spikes, self.ds.labels, self.device, len(self.ds.labels)
                )
            )
        return reference.Truth(
            correct=np.concatenate([p.correct for p in parts]),
            emitted=np.concatenate([p.emitted for p in parts]),
            input_events=parts[0].input_events,
            n=parts[0].n,
        )

    def control(self, draw: np.ndarray):
        """The reference one bit coarser, in the program's place."""
        return reference.as_program_output(self.truth(draw, precision_drop=1))

    def check(self) -> tuple[dict, int]:
        """Gaps of a seeded sample of ``check_sweeps`` of the sweeps made
        (every one, if fewer), and the candidates found wrong."""
        rng = np.random.default_rng(self.seed + 1)
        n_check = min(len(self.done), self.traffic["check_sweeps"])
        picks = sorted(rng.choice(len(self.done), n_check, replace=False).tolist())
        acc_gap, ev_gap, failed = 0, 0.0, 0
        lim = self.traffic["limits"]
        for i in picks:
            draw, accs, stats = self.done[i]
            truth = self.truth(draw)
            for c in range(len(draw)):
                one = reference.Truth(truth.correct[c : c + 1], truth.emitted[c : c + 1],
                                      truth.input_events, truth.n)
                a, e = reference.gaps(accs[c : c + 1], stats[c : c + 1], one)
                acc_gap, ev_gap = max(acc_gap, a), max(ev_gap, e)
                failed += int(a > lim["acc_gap"] or e > lim["event_gap"])
        return {"acc_gap": acc_gap, "event_gap": ev_gap}, failed

    def free(self) -> None:
        """Drop the program's device state before the reference runs."""
        self.qps = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
