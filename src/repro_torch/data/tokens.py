"""Deterministic synthetic LM token pipeline (offline container).

Produces a reproducible, checkpointable stream of {tokens, targets} batches:
a per-(seed, step, shard) keyed generator samples token sequences from a
Zipf-like marginal with short-range Markov structure, so losses fall during
training (there *is* learnable signal) without any external data.

State is a single integer (``step``) -- stored in the checkpoint manifest --
so restore resumes the stream exactly; shard identity makes every data shard
distinct under DP.

This is the port's own copy of ``repro/data/tokens.py`` (numpy only): the
same seed, step and shard give bit-equal batches in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticTokens"]


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    shard: int = 0
    n_shards: int = 1
    step: int = 0

    def __post_init__(self):
        # Zipf-ish marginal + a fixed random bigram drift table (small).
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1)
        self._probs = (1.0 / ranks**1.1)
        self._probs /= self._probs.sum()
        self._drift = rng.integers(1, max(2, self.vocab // 7), size=997)

    def state(self) -> dict:
        return {"step": self.step, "shard": self.shard, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        key = (self.seed * 1_000_003 + self.step) * 4_096 + self.shard
        rng = np.random.default_rng(key)
        base = rng.choice(self.vocab, size=(self.batch, self.seq_len + 1), p=self._probs)
        # Markov structure: token[t+1] correlates with token[t] half the time.
        flip = rng.random((self.batch, self.seq_len)) < 0.5
        drift = self._drift[base[:, :-1] % 997]
        base[:, 1:] = np.where(flip, (base[:, :-1] + drift) % self.vocab, base[:, 1:])
        self.step += 1
        return {
            "tokens": base[:, :-1].astype(np.int32),
            "targets": base[:, 1:].astype(np.int32),
        }
