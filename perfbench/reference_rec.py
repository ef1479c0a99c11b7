"""Plain integer simulation of nets with a dense recurrent (ATA-T) core: the
yardstick of ``correct`` for them.

It imports nothing of the program, only ``reference.py``'s helpers: a layer
that is not ATA-T is quantized and stepped as there.  An ATA-T layer's scale
is the smallest of ``w_max / |w_ff|max``, ``rec_max / |w_rec|max`` and
``(u_max / 2) / theta`` in float32, as the port's
``core/network.py::layer_scale`` computes it, and both matrices are rounded
half to even onto their grids.  Each step adds ``prev_spk @ w_rec`` to the
step's feed-forward current before the membrane update: a float64 product of
0/1 spikes and integer weights, exact since |sum| <= 128 * 2**15 < 2**53.

``precision_drop=1`` is the control: both matrices held one bit coarser
(rounded half to even onto the grid of even integers).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import reference
from perfbench.reference import QLayer, Result, Truth, int_max


def quantize(layers: list[dict], params, cands: list[tuple], precision_drop: int = 0) -> list:
    """``cands``: (ff_bits, rec_bits, leak_bits) per candidate; ``params``:
    per layer (w_ff, w_rec, theta) float32 on the device, w_rec [n_out,
    n_out] for an ATA-T layer.  An ATA-T layer's ``QLayer.w_rec`` is int64
    [C, n_out, n_out]."""
    out = []
    for layer, (w_ff, w_rec, theta) in zip(layers, params):
        if layer["topology"] != "ata_t":
            out += reference.quantize([layer], [(w_ff, w_rec, theta)], cands, precision_drop)
            continue
        f32 = torch.float32
        dev = w_ff.device
        col = lambda vals: torch.tensor(vals, dtype=f32, device=dev)
        w_max = col([float(int_max(c[0])) for c in cands])
        rec_max = col([float(int_max(c[1])) for c in cands])
        eps = torch.tensor(1e-12, dtype=f32, device=dev)
        absmax = w_ff.abs().amax()
        absrec = w_rec.abs().amax()
        scale = w_max / torch.where(absmax == 0, eps, absmax)
        scale = torch.minimum(scale, rec_max / torch.where(absrec == 0, eps, absrec))
        th = torch.where(theta == 0, eps, theta)
        half_u = torch.tensor(0.5 * int_max(layer["u_bits"]), dtype=f32, device=dev)
        scale = torch.minimum(scale, half_u / th)  # [C]
        s3 = scale.view(-1, 1, 1)

        def grid(w, top):
            top = top.view(-1, 1, 1)
            q = torch.minimum(torch.maximum(torch.round(w[None] * s3), -top - 1), top)
            q = q.to(torch.int64)
            for _ in range(precision_drop):
                q = torch.round(q.double() / 2).to(torch.int64) * 2
            return q

        ks = [reference.decay_register(layer["beta"], c[2]) for c in cands]
        out.append(
            QLayer(
                w_ff=grid(w_ff, w_max),
                w_rec=grid(w_rec, rec_max),
                theta=torch.round(theta * scale).to(torch.int64),
                k=torch.tensor(ks, dtype=torch.int64, device=dev),
            )
        )
    return out


def layer_window(layer: dict, q: QLayer, cur: torch.Tensor) -> torch.Tensor:
    """Spikes bool [C, T, B, N] of one LIF layer from currents int64 [C, T,
    B, N]; an ATA-T layer adds its recurrence each step."""
    if layer["topology"] != "ata_t":
        return reference.layer_window(layer, q, cur)
    C, T, B, N = cur.shape
    lo, hi = -int_max(layer["u_bits"]) - 1, int_max(layer["u_bits"])
    col = lambda t: t.view(C, 1, 1)
    theta, k = col(q.theta), col(q.k)
    w_rec = q.w_rec.to(torch.float64)
    u = torch.zeros(C, B, N, dtype=torch.int64, device=cur.device)
    prev = torch.zeros(C, B, N, dtype=torch.float64, device=cur.device)
    spikes = torch.empty(C, T, B, N, dtype=torch.bool, device=cur.device)
    for t in range(T):
        acc = cur[:, t] + torch.bmm(prev, w_rec).to(torch.int64)
        u = (u + acc).clamp(lo, hi)
        spk = u >= theta
        if layer["reset"] == "zero":
            reset = torch.zeros_like(u)
        else:
            reset = (u - theta).clamp(lo, hi)
        u = torch.where(spk, reset, reference._decay(u, k).clamp(lo, hi))
        prev = spk.to(torch.float64)
        spikes[:, t] = spk
    return spikes


def simulate(layers: list[dict], qs: list[QLayer], raster: torch.Tensor) -> Result:
    """Every candidate of ``qs`` on ``raster`` (int [T, B, n_in] on the device)."""
    T, B, _ = raster.shape
    x = raster.to(torch.bool)[None]  # [1, T, B, n_in]
    emitted, inputs = [], []
    for layer, q in zip(layers, qs):
        inputs.append(x)
        C = q.w_ff.shape[0]
        xs = x.to(torch.float64).reshape(x.shape[0], T * B, -1)
        cur = torch.matmul(xs, q.w_ff.to(torch.float64)).to(torch.int64)
        x = layer_window(layer, q, cur.reshape(C, T, B, -1))
        emitted.append(x.sum(dim=(2, 3)))
    return Result(
        counts=x.sum(dim=1, dtype=torch.int64),
        emitted=torch.stack(emitted, dim=2),
        input_events=raster.to(torch.bool).sum(dim=(1, 2)),
        inputs=inputs,
    )


def evaluate(layers, qs, spikes: np.ndarray, labels: np.ndarray, device, sample_block: int) -> Truth:
    """Accuracy counts and event totals of every candidate over the samples
    (uint8 [n, T, n_in], labels [n]), in blocks of ``sample_block`` samples."""
    n = len(labels)
    correct = emitted = input_events = None
    for lo in range(0, n, sample_block):
        hi = min(n, lo + sample_block)
        raster = torch.from_numpy(np.ascontiguousarray(spikes[lo:hi].transpose(1, 0, 2)))
        res = simulate(layers, qs, raster.to(device))
        preds = torch.argmax(res.counts, dim=-1).cpu().numpy()
        c = (preds == labels[None, lo:hi]).sum(axis=1)
        e, i = res.emitted.cpu().numpy(), res.input_events.cpu().numpy()
        correct = c if correct is None else correct + c
        emitted = e if emitted is None else emitted + e
        input_events = i if input_events is None else input_events + i
    return Truth(correct=correct, emitted=emitted, input_events=input_events, n=n)
