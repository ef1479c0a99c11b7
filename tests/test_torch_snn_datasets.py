"""The port's synthetic datasets against the JAX package's, case for case.

``test_snn_datasets.py``'s contracts pointed at ``repro_torch.data.
snn_datasets`` -- same seed, same rasters; shapes, dtypes and ranges; split
partitions; ``batches`` covering every sample with the ragged tail; rate
encoding bounds -- and beside them the port's rasters and labels
byte-identical to JAX's for the same seeds and keyword arguments, and
``raster_tensor`` giving int32 on the device it is asked for.
"""

import numpy as np
import pytest
import torch

from repro.data import snn_datasets as jds
from repro_torch.data.snn_datasets import (
    SpikeDataset,
    dvs_like,
    mnist_like,
    raster_tensor,
    rate_encode,
    shd_like,
)

GENERATORS = [
    (mnist_like, dict(n=96, T=8, seed=3), 10, 256),
    (shd_like, dict(n=96, T=8, seed=3), 20, 140),
    (dvs_like, dict(n=96, T=8, seed=3), 11, 256),
]


@pytest.mark.parametrize("gen,kwargs,n_classes,channels", GENERATORS)
def test_same_seed_same_rasters(gen, kwargs, n_classes, channels):
    a = gen(**kwargs)
    b = gen(**kwargs)
    assert np.array_equal(a.spikes, b.spikes)
    assert np.array_equal(a.labels, b.labels)
    c = gen(**{**kwargs, "seed": kwargs["seed"] + 1})
    assert not np.array_equal(a.spikes, c.spikes)


@pytest.mark.parametrize("gen,kwargs,n_classes,channels", GENERATORS)
def test_interface_shapes_and_ranges(gen, kwargs, n_classes, channels):
    ds = gen(**kwargs)
    n, T = kwargs["n"], kwargs["T"]
    assert ds.spikes.shape == (n, T, channels)
    assert ds.spikes.dtype == np.uint8
    assert set(np.unique(ds.spikes)) <= {0, 1}
    assert ds.labels.shape == (n,)
    assert ds.n_classes == n_classes
    assert ds.labels.min() >= 0 and ds.labels.max() < n_classes
    assert len(np.unique(ds.labels)) == n_classes


@pytest.mark.parametrize("gen,kwargs,n_classes,channels", GENERATORS)
def test_split_partitions_without_overlap(gen, kwargs, n_classes, channels):
    ds = gen(**kwargs)
    train, test = ds.split(0.75)
    assert len(train.labels) + len(test.labels) == len(ds.labels)
    assert np.array_equal(np.concatenate([train.spikes, test.spikes]), ds.spikes)
    assert np.array_equal(np.concatenate([train.labels, test.labels]), ds.labels)
    assert train.n_classes == test.n_classes == ds.n_classes


def _toy_dataset(n: int) -> SpikeDataset:
    spikes = np.arange(n * 2 * 3, dtype=np.uint8).reshape(n, 2, 3) % 2
    return SpikeDataset(spikes, np.arange(n, dtype=np.int32), n_classes=n, name="toy")


def test_batches_yields_ragged_tail():
    got = list(_toy_dataset(10).batches(4))
    assert [len(labels) for _, labels in got] == [4, 4, 2]
    seen = np.concatenate([labels for _, labels in got])
    assert sorted(seen.tolist()) == list(range(10))
    for spikes, labels in got:
        assert spikes.shape == (2, len(labels), 3)


def test_batches_shuffled_epoch_still_covers_every_sample():
    seen = np.concatenate([l for _, l in _toy_dataset(11).batches(4, np.random.default_rng(0))])
    assert sorted(seen.tolist()) == list(range(11))


def test_batches_batch_larger_than_dataset_and_empty():
    got = list(_toy_dataset(3).batches(64))
    assert len(got) == 1 and len(got[0][1]) == 3
    empty = SpikeDataset(np.zeros((0, 2, 3), np.uint8), np.zeros((0,), np.int32), 1, "empty")
    assert list(empty.batches(4)) == []


def test_batches_pairs_spikes_with_their_labels_under_shuffle():
    n = 9
    spikes = np.zeros((n, 1, 16), np.uint8)
    for i in range(n):
        spikes[i, 0, i] = 1
    ds = SpikeDataset(spikes, np.arange(n, dtype=np.int32), n, "aligned")
    for batch, labels in ds.batches(4, np.random.default_rng(1)):
        for j, lab in enumerate(labels):
            assert batch[0, j, lab] == 1


def test_rate_encode_probability_bounds():
    raster = rate_encode(np.linspace(0.0, 1.0, 64), T=400, rng=np.random.default_rng(0),
                         max_rate=0.5)
    assert raster.shape == (400, 64)
    assert raster[:, 0].sum() == 0
    assert abs(raster.mean(axis=0)[-1] - 0.5) < 0.1


# -- against the JAX package ------------------------------------------------

JAX_GENERATORS = {"mnist_like": jds.mnist_like, "shd_like": jds.shd_like, "dvs_like": jds.dvs_like}


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("mnist_like", dict(n=96, T=8, seed=3)),
        ("mnist_like", dict(n=2048, T=25, seed=0)),  # the quickstart's set
        ("mnist_like", dict(n=64, T=6, seed=11, max_rate=0.6)),
        ("shd_like", dict(n=96, T=8, seed=3)),
        ("shd_like", dict(n=40, T=12, seed=5, channels=70, n_classes=7)),
        ("dvs_like", dict(n=96, T=8, seed=3)),
        ("dvs_like", dict(n=1408, T=20, seed=2)),  # the DSE example's set
    ],
)
def test_rasters_and_labels_byte_identical_to_jax(name, kwargs):
    got = globals()[name](**kwargs)
    want = JAX_GENERATORS[name](**kwargs)
    assert got.spikes.dtype == want.spikes.dtype and got.labels.dtype == want.labels.dtype
    assert got.spikes.tobytes() == want.spikes.tobytes()
    assert got.labels.tobytes() == want.labels.tobytes()
    assert (got.n_classes, got.name) == (want.n_classes, want.name)
    for (gs, gl), (ws, wl) in zip(got.batches(32, np.random.default_rng(4)),
                                  want.batches(32, np.random.default_rng(4))):
        assert gs.tobytes() == ws.tobytes() and gl.tobytes() == wl.tobytes()


def test_rate_encode_equals_jax():
    intensity = np.random.default_rng(2).random(96)
    got = rate_encode(intensity, T=30, rng=np.random.default_rng(9), max_rate=0.4)
    want = jds.rate_encode(intensity, T=30, rng=np.random.default_rng(9), max_rate=0.4)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_raster_tensor_is_int32_on_the_device_asked_for():
    ds = mnist_like(n=8, T=5, seed=0)
    x = raster_tensor(ds.spikes[0], "cpu")
    assert x.dtype == torch.int32 and x.device == torch.device("cpu")
    assert np.array_equal(x.numpy(), ds.spikes[0].astype(np.int32))
    graded = np.array([[0, 3, 7], [255, 1, 0]], np.int64)
    np.testing.assert_array_equal(raster_tensor(graded, "cpu").numpy(), graded)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            raster_tensor(ds.spikes[0])
    else:
        assert raster_tensor(ds.spikes[0]).device.type == "cuda"
