"""Inputs and weights of a run, made on the device from ``--seed``.

``heldout_rasters`` draws digit-glyph spike rasters as the port's
``data/snn_datasets.py::mnist_like`` draws them (16x16 glyphs of a 3x5 font
scaled by 3, a jittered offset, stroke intensity, background noise and pen
gaps, Bernoulli rate coding at ``max_rate``), vectorized, with one change:
every seed draws the ten classes in the same numbers (``n // 10`` each, the
first ``n % 10`` classes one more), in its own order, so that the work of a
run does not move with the seed's mix of glyphs.  A seed gives the same
rasters on every run, though not the stream of ``mnist_like`` itself.
``float_weights`` draws the net's float parameters as the port's
``init_float_params`` lays them out: uniform(+-1/sqrt(fan_in)) feed-forward
weights, the ATA-F self-weight register at 0.1, theta at the layer's
threshold.  Both use a ``torch.Generator`` on the run's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_FONT_3X5 = {
    0: ["111", "101", "101", "101", "111"],
    1: ["010", "110", "010", "010", "111"],
    2: ["111", "001", "111", "100", "111"],
    3: ["111", "001", "111", "001", "111"],
    4: ["101", "101", "111", "001", "001"],
    5: ["111", "100", "111", "001", "111"],
    6: ["111", "100", "111", "101", "111"],
    7: ["111", "001", "010", "010", "010"],
    8: ["111", "101", "111", "101", "111"],
    9: ["111", "101", "111", "001", "111"],
}
_OFFSETS_Y = (0, 1)  # 15 glyph rows in 16
_OFFSETS_X = tuple(range(6))  # 9 glyph columns at 2 + (-2..3)


def glyph_templates() -> np.ndarray:
    """float32 [10, 2, 6, 256]: each digit at each offset, intensity 1."""
    out = np.zeros((10, len(_OFFSETS_Y), len(_OFFSETS_X), 16, 16), np.float32)
    for d, rows in _FONT_3X5.items():
        bitmap = np.array([[int(c) for c in r] for r in rows], np.float32)
        up = np.kron(bitmap, np.ones((3, 3), np.float32))  # 15 x 9
        for i, oy in enumerate(_OFFSETS_Y):
            for j, ox in enumerate(_OFFSETS_X):
                out[d, i, j, oy : oy + 15, ox : ox + 9] = up
    return out.reshape(10, len(_OFFSETS_Y), len(_OFFSETS_X), 256)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run's seed."""
    return torch.Generator(device=device).manual_seed(seed * 16 + stream)


def heldout_rasters(
    seed: int, stream: int, n: int, T: int, max_rate: float, device
) -> tuple[np.ndarray, np.ndarray]:
    """``n`` samples: uint8 spikes [n, T, 256] and int32 labels [n], on the host."""
    gen = generator(seed, stream, device)
    u = lambda *shape: torch.rand(*shape, generator=gen, device=device)
    # the same ten classes in the same numbers for every seed, in another order
    order = torch.randperm(n, generator=gen, device=device)
    labels = torch.arange(n, device=device)[order] % 10
    oy = torch.randint(0, len(_OFFSETS_Y), (n,), generator=gen, device=device)
    ox = torch.randint(0, len(_OFFSETS_X), (n,), generator=gen, device=device)
    tmpl = torch.from_numpy(glyph_templates()).to(device)
    img = tmpl[labels, oy, ox] * (0.7 + 0.3 * u(n, 1))
    img = img + 0.08 * u(n, 256)
    img = img * (u(n, 256) > 0.05)
    p = (img.clamp(0.0, 1.0) * max_rate).clamp(0.0, 1.0)
    spikes = torch.empty(n, T, 256, dtype=torch.uint8, device=device)
    for t in range(T):  # one [n, 256] draw a step keeps the peak small
        spikes[:, t] = u(n, 256) < p
    return spikes.cpu().numpy(), labels.to(torch.int32).cpu().numpy()


def float_weights(seed: int, layers: list[dict], device) -> list[tuple]:
    """Per layer ``(w_ff f32 [n_in, n_out], w_rec f32, theta f32 [])``."""
    gen = generator(seed, 15, device)
    out = []
    for layer in layers:
        lim = 1.0 / math.sqrt(layer["n_in"])
        shape = (layer["n_in"], layer["n_out"])
        w_ff = torch.rand(shape, generator=gen, device=device) * (2 * lim) - lim
        if layer["topology"] == "ata_f":
            w_rec = torch.tensor(0.1, dtype=torch.float32, device=device)
        else:
            w_rec = torch.zeros(0, dtype=torch.float32, device=device)
        theta = torch.tensor(layer["threshold"], dtype=torch.float32, device=device)
        out.append((w_ff, w_rec, theta))
    return out
