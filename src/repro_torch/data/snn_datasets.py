"""Seeded synthetic stand-ins for the paper's three benchmarks.

The container is offline, so MNIST / SHD / DVS-Gesture themselves are not
available.  These generators produce datasets with the same *interface*
(spike rasters shaped [N, T, channels] + integer labels) and the same
structural character:

* ``mnist_like``  -- 16x16 rendered digit glyphs (the paper downscales MNIST
  to <=16x16 = 256 channels) with spatial jitter + pixel noise, rate-coded
  into Bernoulli spike trains.
* ``shd_like``    -- 20-class synthetic cochleagrams: class-keyed
  spectro-temporal ridge patterns over 140 channels (700 cochlear channels
  reduced by k=5, as the paper's 700/k < 256 rule), inherently spike-based.
* ``dvs_like``    -- 11-class moving-edge event streams on a 16x16 grid
  (256 channels after the paper's conv-front-end compression), direction /
  speed encode the class.

Everything is generated from a numpy Generator seed => bit-reproducible.
This is the port's own copy of ``repro/data/snn_datasets.py``: the same
seeds give the same rasters.  :func:`raster_tensor` hands a raster to the
simulator as an int32 tensor on a device (``cuda`` unless the caller asks
for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = [
    "SpikeDataset",
    "mnist_like",
    "shd_like",
    "dvs_like",
    "rate_encode",
    "raster_tensor",
]


def raster_tensor(spikes: np.ndarray, device: str | torch.device = "cuda") -> torch.Tensor:
    """A numpy spike raster as an int32 tensor on ``device`` (copied as
    uint8 when it fits, then widened on the device: a quarter of the bytes)."""
    dev = resolve_device(device)
    spikes = np.ascontiguousarray(spikes)
    return torch.from_numpy(spikes).to(dev).to(torch.int32)


@dataclasses.dataclass
class SpikeDataset:
    spikes: np.ndarray  # uint8 [N, T, C]
    labels: np.ndarray  # int32 [N]
    n_classes: int
    name: str

    def split(self, train_frac: float = 0.85):
        n_train = int(len(self.labels) * train_frac)
        tr = SpikeDataset(self.spikes[:n_train], self.labels[:n_train], self.n_classes, self.name + ":train")
        te = SpikeDataset(self.spikes[n_train:], self.labels[n_train:], self.n_classes, self.name + ":test")
        return tr, te

    def batches(self, batch_size: int, rng: np.random.Generator | None = None):
        """Yield ``([T, B, C] spikes, labels)`` batches over the whole set.

        Every sample is yielded exactly once per pass: a ragged final batch
        (``len % batch_size`` samples) is yielded too, not dropped -- so one
        epoch sees the entire dataset and dataset-level statistics weight
        every sample equally.  Consumers that jit over the batch shape pay
        one extra compile for the tail shape per pass.
        """
        idx = np.arange(len(self.labels))
        if rng is not None:
            rng.shuffle(idx)
        if not len(idx):
            return
        batch_size = min(batch_size, len(idx))
        for i in range(0, len(idx), batch_size):
            sel = idx[i : i + batch_size]
            # time-major for lax.scan: [T, B, C]
            yield self.spikes[sel].transpose(1, 0, 2), self.labels[sel]


# 3x5 digit glyph bitmaps (rows of 3 bits), a standard tiny font.
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


def _glyph16(digit: int, rng: np.random.Generator) -> np.ndarray:
    """Render a digit into a 16x16 intensity image with jitter and noise."""
    bitmap = np.array(
        [[int(c) for c in row] for row in _FONT_3X5[digit]], dtype=np.float32
    )
    # Upsample 3x5 -> 9x15 (x3), pad into 16x16 with a jittered offset.
    up = np.kron(bitmap, np.ones((3, 3), np.float32))  # 15 x 9
    img = np.zeros((16, 16), np.float32)
    oy = 0 + rng.integers(0, 2)  # 15 rows fit with 1 px slack
    ox = 2 + rng.integers(-2, 4)  # 9 cols, up to +-2..3 px shift
    img[oy : oy + up.shape[0], ox : ox + up.shape[1]] = up
    # Stroke-intensity variation + background noise (MNIST-ish greys).
    img *= rng.uniform(0.7, 1.0)
    img += rng.uniform(0.0, 0.08, img.shape)
    # Random pixel dropout on the glyph (pen gaps).
    img *= rng.random(img.shape) > 0.05
    return np.clip(img, 0.0, 1.0)


def rate_encode(intensity: np.ndarray, T: int, rng: np.random.Generator, max_rate: float = 0.35) -> np.ndarray:
    """Bernoulli rate coding: P(spike at t) = intensity * max_rate."""
    p = np.clip(intensity[None, :] * max_rate, 0.0, 1.0)
    return (rng.random((T, intensity.size)) < p).astype(np.uint8)


def mnist_like(n: int = 4096, T: int = 25, seed: int = 0, max_rate: float = 0.35) -> SpikeDataset:
    rng = np.random.default_rng(seed)
    spikes = np.zeros((n, T, 256), np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int32)
    for i in range(n):
        img = _glyph16(int(labels[i]), rng)
        spikes[i] = rate_encode(img.reshape(-1), T, rng, max_rate)
    return SpikeDataset(spikes, labels, 10, "mnist-like")


def shd_like(n: int = 3000, T: int = 40, seed: int = 1, channels: int = 140, n_classes: int = 20) -> SpikeDataset:
    """Class-keyed spectro-temporal ridges: each class is a set of 3 channel
    trajectories (start, slope) fixed by a per-class seed; events are Poisson
    around the ridge with temporal jitter -- qualitatively like spoken-digit
    cochleagrams."""
    rng = np.random.default_rng(seed)
    class_rng = np.random.default_rng(seed + 999)
    ridges = class_rng.uniform(0, channels, (n_classes, 3))
    slopes = class_rng.uniform(-1.0, 1.0, (n_classes, 3)) * channels / (2 * T)
    widths = class_rng.uniform(2.0, 6.0, (n_classes, 3))

    spikes = np.zeros((n, T, channels), np.uint8)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    ch = np.arange(channels, dtype=np.float32)
    for i in range(n):
        c = int(labels[i])
        jitter = rng.normal(0, 3.0, 3)
        speed = rng.uniform(0.85, 1.15)
        for t in range(T):
            rate = np.zeros(channels, np.float32)
            for r in range(3):
                center = (ridges[c, r] + jitter[r] + slopes[c, r] * t * speed) % channels
                rate += 0.5 * np.exp(-0.5 * ((ch - center) / widths[c, r]) ** 2)
            rate += 0.01  # spontaneous activity
            spikes[i, t] = rng.random(channels) < np.clip(rate, 0, 0.9)
    return SpikeDataset(spikes, labels, n_classes, "shd-like")


def dvs_like(n: int = 2816, T: int = 30, seed: int = 2, n_classes: int = 11) -> SpikeDataset:
    """Drifting-grating events on a 16x16 grid; class = (orientation,
    spatial wavelength, drift speed) -- what a DVS camera sees for a moving
    periodic gesture after the paper's conv front-end compression.  The
    orientation/wavelength signature is spatially decodable (feed-forward
    SNNs learn it) while drift speed adds the temporal component recurrent
    topologies exploit."""
    rng = np.random.default_rng(seed)
    grid = 16
    spikes = np.zeros((n, T, grid * grid), np.uint8)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    yy, xx = np.mgrid[0:grid, 0:grid].astype(np.float32)
    class_rng = np.random.default_rng(seed + 123)
    angles = class_rng.permutation(n_classes) * np.pi / n_classes
    wavelengths = 3.0 + class_rng.permutation(n_classes) % 4  # 3..6 px
    speeds = class_rng.uniform(0.15, 0.6, n_classes)
    class_phase = class_rng.uniform(0, 2 * np.pi, n_classes)
    for i in range(n):
        c = int(labels[i])
        ang = angles[c] + rng.normal(0, 0.06)
        lam = wavelengths[c] * rng.uniform(0.95, 1.05)
        spd = speeds[c] * rng.uniform(0.9, 1.1)
        phase = class_phase[c] + rng.normal(0, 0.3)
        proj = xx * np.cos(ang) + yy * np.sin(ang)
        for t in range(T):
            wave = np.sin(2 * np.pi * proj / lam + phase + spd * t)
            p = 0.45 * (wave > 0.3) + 0.01
            spikes[i, t] = (rng.random((grid, grid)) < p).reshape(-1)
    return SpikeDataset(spikes, labels, n_classes, "dvs-like")
