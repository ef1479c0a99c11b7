"""Plain integer simulation of the 256-128-10 nets: the yardstick of ``correct``.

It imports nothing of the program.  From the float weights that the program is
handed too, it derives each candidate's quantized weights, threshold and decay
register again (a frozen copy of the port's quantizer and coefficient-generator
arithmetic: ``core/network.py::layer_scale`` / ``quantize_params`` in float32,
``core/coeff_gen.py::encode_decay``), then steps every layer in int64 with
saturation at the membrane width.  Feed-forward currents are float64 products
of spikes and integer weights, exact for any sum below 2**53.

``precision_drop=1`` is the control: every weight held one bit coarser than the
candidate states (rounded half to even onto the grid of even integers), the
step a faster but lossy product would take.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def int_max(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def decay_register(beta: float, leak_bits: int) -> int:
    """The packed DecayRate register of a leak ``beta`` on ``leak_bits`` taps:
    k/256 on the taps' grid, or 256 (bypass) where beta rounds to 1."""
    step = 1 << (8 - leak_bits)
    k = int(round(beta * 256.0 / step)) * step
    return 256 if k >= 256 else k


@dataclasses.dataclass
class QLayer:
    """One layer's integer parameters for C candidates, on the device."""

    w_ff: torch.Tensor  # int64 [C, n_in, n_out]
    w_rec: torch.Tensor  # int64 [C] (ATA-F self-weight; zeros for FF)
    theta: torch.Tensor  # int64 [C]
    k: torch.Tensor  # int64 [C] decay registers


def quantize(layers: list[dict], params, cands: list[tuple], precision_drop: int = 0) -> list:
    """``cands``: (ff_bits, rec_bits, leak_bits) per candidate; ``params``:
    per layer (w_ff, w_rec, theta) float32 on the device."""
    f32 = torch.float32
    dev = params[0][0].device
    out = []
    for layer, (w_ff, w_rec, theta) in zip(layers, params):
        col = lambda vals: torch.tensor(vals, dtype=f32, device=dev)
        w_max = col([float(int_max(c[0])) for c in cands])
        rec_max = col([float(int_max(c[1])) for c in cands])
        eps = torch.tensor(1e-12, dtype=f32, device=dev)
        absmax = w_ff.abs().amax()
        scale = w_max / torch.where(absmax == 0, eps, absmax)
        ata_f = layer["topology"] == "ata_f"
        if ata_f:
            absrec = w_rec.abs()
            scale = torch.minimum(scale, rec_max / torch.where(absrec == 0, eps, absrec))
        th = torch.where(theta == 0, eps, theta)
        half_u = torch.tensor(0.5 * int_max(layer["u_bits"]), dtype=f32, device=dev)
        scale = torch.minimum(scale, half_u / th)  # [C]
        s3 = scale.view(-1, 1, 1)
        wq = torch.round(w_ff[None] * s3)
        wq = torch.minimum(torch.maximum(wq, -w_max.view(-1, 1, 1) - 1), w_max.view(-1, 1, 1))
        if ata_f:
            rq = torch.round(w_rec * scale)
            rq = torch.minimum(torch.maximum(rq, -rec_max - 1), rec_max)
        else:
            rq = torch.zeros_like(scale)
        wq, rq = wq.to(torch.int64), rq.to(torch.int64)
        for _ in range(precision_drop):
            wq = torch.round(wq.double() / 2).to(torch.int64) * 2
            rq = torch.round(rq.double() / 2).to(torch.int64) * 2
        ks = [decay_register(layer["beta"], c[2]) for c in cands]
        out.append(
            QLayer(
                w_ff=wq,
                w_rec=rq,
                theta=torch.round(theta * scale).to(torch.int64),
                k=torch.tensor(ks, dtype=torch.int64, device=dev),
            )
        )
    return out


def _decay(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The coefficient generator: the sum of u >> s over the set bits of k
    (bit 8 - s selects shift s), or u itself where k is the bypass."""
    acc = torch.zeros_like(u)
    for s in range(1, 9):
        acc = acc + ((k >> (8 - s)) & 1) * (u >> s)
    return torch.where(k >= 256, u, acc)


def layer_window(layer: dict, q: QLayer, cur: torch.Tensor) -> torch.Tensor:
    """Spikes bool [C, T, B, N] of one LIF layer from currents int64 [C, T, B, N]."""
    C, T, B, N = cur.shape
    lo, hi = -int_max(layer["u_bits"]) - 1, int_max(layer["u_bits"])
    col = lambda t: t.view(C, 1, 1)
    theta, w_rec, k = col(q.theta), col(q.w_rec), col(q.k)
    u = torch.zeros(C, B, N, dtype=torch.int64, device=cur.device)
    prev = torch.zeros(C, B, N, dtype=torch.int64, device=cur.device)
    spikes = torch.empty(C, T, B, N, dtype=torch.bool, device=cur.device)
    for t in range(T):
        acc = cur[:, t]
        if layer["topology"] == "ata_f":
            acc = acc + prev * w_rec
        u = (u + acc).clamp(lo, hi)
        spk = u >= theta
        if layer["reset"] == "zero":
            reset = torch.zeros_like(u)
        else:
            reset = (u - theta).clamp(lo, hi)
        u = torch.where(spk, reset, _decay(u, k).clamp(lo, hi))
        prev = spk.to(torch.int64)
        spikes[:, t] = spk
    return spikes


@dataclasses.dataclass
class Result:
    """Totals over a block of samples, per candidate."""

    counts: torch.Tensor  # int64 [C, B, n_classes] output spikes
    emitted: torch.Tensor  # int64 [C, T, L] events emitted per step, summed over samples
    input_events: torch.Tensor  # int64 [T]
    inputs: list  # per layer: bool / int [Cx, T, B, n_in] its input spikes


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


@dataclasses.dataclass
class Truth:
    """What the reference says of one evaluation of C candidates on n samples."""

    correct: np.ndarray  # int64 [C]
    emitted: np.ndarray  # int64 [C, T, L]
    input_events: np.ndarray  # int64 [T]
    n: int


def evaluate(
    layers: list[dict],
    qs: list[QLayer],
    spikes: np.ndarray,
    labels: np.ndarray,
    device,
    sample_block: int,
    on_block=None,
) -> Truth:
    """Accuracy counts and event totals of every candidate over the samples
    (uint8 [n, T, n_in], labels [n]), in blocks of ``sample_block`` samples.
    ``on_block(result, lo, hi)`` sees each block's :class:`Result`."""
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
        if on_block is not None:
            on_block(res, lo, hi)
    return Truth(correct=correct, emitted=emitted, input_events=input_events, n=n)


def as_program_output(truth: Truth):
    """The reference's answer in the form ``eval_int_population(...,
    return_stats=True)`` gives: accuracies and per-candidate event means."""
    accs = truth.correct / max(1, truth.n)
    mean = lambda a: (a / truth.n).astype(np.float32)
    stats = [
        {
            "input_events_per_step": mean(truth.input_events),
            "layer_events_per_step": [mean(truth.emitted[c, :, l]) for l in range(truth.emitted.shape[2])],
        }
        for c in range(len(truth.correct))
    ]
    return accs, stats


def gaps(accs, stats, truth: Truth) -> tuple[int, float]:
    """The two numbers compared: the most samples by which a candidate's
    correct count differs from the reference's, and the most events by which
    a per-step total (input, or emitted by a layer) differs, over the
    candidates, steps and layers."""
    n = truth.n
    got = np.rint(np.asarray(accs, np.float64) * n).astype(np.int64)
    acc_gap = int(np.abs(got - truth.correct).max())
    ev_gap = 0.0
    for c, st in enumerate(stats):
        ins = np.asarray(st["input_events_per_step"], np.float64) * n
        ev_gap = max(ev_gap, float(np.abs(ins - truth.input_events).max()))
        for l, per_step in enumerate(st["layer_events_per_step"]):
            e = np.asarray(per_step, np.float64) * n
            ev_gap = max(ev_gap, float(np.abs(e - truth.emitted[c, :, l]).max()))
    return acc_gap, ev_gap
