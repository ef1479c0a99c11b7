"""BPTT training and evaluation of Flexi-NeurA networks (port of
``repro/snn/train.py``, the Flex-plorer "Learning" stage).

:func:`train_snn` trains the float model with surrogate gradients
(hardware-ordered dynamics, ``core.snn_layer.float_layer_step``) or, with
``qat=``, quantization-aware through ``snn.qat.run_qat``, whose forward is
the deployment datapath (on the card, ``spike_matmul`` in every step's phase
A).  :func:`eval_float` scores the float model; :func:`eval_int` is the
bit-exact hardware-faithful accuracy the DSE and the deployment path use,
and :func:`eval_int_population` scores a whole population of precision
candidates per data batch (the population DSE sweep).

Training runs on ``device`` (the card unless the caller asks for the CPU)
with float32 products at full precision, whatever the caller's TF32
setting (``_device.full_f32_matmul``).

:func:`eval_int` and :func:`eval_int_population` mark their stages with
``repro_torch.kernels.work.span`` (``eval.gather`` and ``eval.h2d``,
``population.*``), which cost one ``ContextVar`` read each while nothing
listens.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import full_f32_matmul, resolve_device
from repro_torch.core import backend as backend_lib
from repro_torch.core import shard as shard_lib
from repro_torch.core.backend import _batch_mean
from repro_torch.core.network import NetworkConfig, init_float_params, run_float
from repro_torch.core.snn_layer import FloatLayerParams
from repro_torch.data.snn_datasets import SpikeDataset, raster_tensor
from repro_torch.kernels import work
from repro_torch.snn import qat as qat_lib
from repro_torch.snn.surrogate import fast_sigmoid
from repro_torch.train import optimizer as opt_lib

__all__ = [
    "TrainResult",
    "train_snn",
    "eval_float",
    "eval_int",
    "eval_int_population",
    "spike_count_loss",
]


def spike_count_loss(counts, labels, rate_reg: float = 1e-4, total_spikes=None):
    """Cross-entropy over output spike counts (rate decoding) + rate penalty.

    The rate penalty encourages the sparsity that the event-driven hardware's
    latency/energy model rewards.  ``counts`` may carry a leading candidate
    axis ([K, batch, C], labels shared): the loss is then [K], one per
    candidate, and ``total_spikes`` is each candidate's total ([K]).
    """
    logp = torch.log_softmax(counts.to(torch.float32), dim=-1)
    idx = labels.to(torch.int64).expand(counts.shape[:-1]).unsqueeze(-1)
    ce = -logp.gather(-1, idx).squeeze(-1).mean(dim=-1)
    reg = 0.0
    if total_spikes is not None:
        reg = rate_reg * (total_spikes if counts.dim() == 3 else torch.mean(total_spikes))
    return ce + reg


@dataclasses.dataclass
class TrainResult:
    params: list
    history: list[dict]
    net: NetworkConfig
    # set when trained quantization-aware: the precision-overridden network
    # the parameters were trained *for* (deploy by quantize_params on it)
    qat_net: NetworkConfig | None = None


def _leaves(params) -> list[torch.Tensor]:
    """The flat parameter list in JAX's tree order (per layer: w_ff, w_rec,
    theta), detached."""
    return [t.detach() for p in params for t in p]


def _layers(leaves) -> list[FloatLayerParams]:
    return [FloatLayerParams(*leaves[i : i + 3]) for i in range(0, len(leaves), 3)]


def _train_step(loss_fn, optimizer, leaves, opt_state, batch_dims: int = 0):
    """One optimizer step: the loss's gradient (summed over a candidate axis,
    which gives each candidate its own), clipped to global norm 1 (per
    candidate with ``batch_dims=1``), one AdamW update.  Returns ``(leaves,
    opt_state, loss, acc)``, loss and acc as device tensors."""
    ps = [t.detach().requires_grad_() for t in leaves]
    loss, acc = loss_fn(_layers(ps))
    grads = torch.autograd.grad(loss.sum(), ps, allow_unused=True)
    with torch.no_grad():
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, ps)]
        grads, _ = opt_lib.clip_by_global_norm(grads, 1.0, batch_dims)
        updates, opt_state = optimizer.update(grads, opt_state, leaves)
        leaves = opt_lib.apply_updates(leaves, updates)
    return leaves, opt_state, loss.detach(), acc


def _float_batch(spikes: np.ndarray, labels: np.ndarray, device) -> tuple:
    return (
        raster_tensor(spikes, device).to(torch.float32),
        torch.from_numpy(labels.astype(np.int64)).to(device),
    )


def _on(params, device: torch.device, what: str) -> None:
    """Raise unless every tensor lies on ``device`` (``cuda`` means any card
    index; ``cuda:1`` that one)."""
    for p in params:
        for t in p:
            if t.device.type != device.type or device.index not in (None, t.device.index):
                raise ValueError(
                    f"{what} are on {t.device}, training runs on {device}: pass "
                    f"device={str(t.device)!r} or move them first"
                )


def train_snn(
    net: NetworkConfig,
    train_ds: SpikeDataset,
    *,
    epochs: int = 8,
    batch_size: int = 128,
    lr: float = 2e-3,
    seed: int = 0,
    rate_reg: float = 1e-4,
    surrogate_slope: float = 25.0,
    log_every: int = 0,
    eval_ds: SpikeDataset | None = None,
    qat: "qat_lib.PrecisionConfig | NetworkConfig | None" = None,
    init_params: list | None = None,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Surrogate-gradient BPTT on ``device``; optionally quantization-aware.

    ``qat`` switches the forward pass to the straight-through fake-quant
    simulation (``repro_torch.snn.qat.run_qat``) at the given precisions --
    a :class:`~repro_torch.snn.qat.PrecisionConfig` overrides ``net``'s
    precision knobs, a full :class:`NetworkConfig` is used as-is (it must
    share ``net``'s structure).  The trained parameters then deploy through
    the ordinary ``quantize_params`` -> ``eval_int`` path bit-exactly at
    those precisions.

    ``init_params`` warm-starts from existing float parameters, which must
    already be on ``device`` (nothing is moved quietly); without them the
    parameters come from ``init_float_params(torch.Generator().manual_seed(
    seed), net)`` -- not the JAX package's ``jax.random`` draw.  Batches
    come from ``np.random.default_rng(seed)``, as in JAX, so both packages
    see the same batch order; one AdamW step per batch, warm-up over the
    first epoch, then cosine decay, gradients clipped to global norm 1.
    Returns parameters as plain tensors on ``device``.
    """
    dev = resolve_device(device)
    if init_params is None:
        params = init_float_params(torch.Generator().manual_seed(seed), net, device=dev)
    else:
        _on(init_params, dev, "init_params")
        params = list(init_params)
    spike_fn = fast_sigmoid(surrogate_slope)
    if qat is None:
        qat_net = None
    elif isinstance(qat, qat_lib.PrecisionConfig):
        qat_net = qat.apply(net)
    else:
        qat_net = qat

    # ceil: `SpikeDataset.batches` yields the ragged tail batch too, so an
    # epoch really takes ceil(n / batch) optimizer steps (schedule horizon)
    eff_batch = min(batch_size, len(train_ds.labels))
    steps_per_epoch = max(1, -(-len(train_ds.labels) // eff_batch))
    optimizer = opt_lib.adamw(
        opt_lib.linear_warmup_cosine(lr, steps_per_epoch, epochs * steps_per_epoch)
    )
    leaves = _leaves(params)
    opt_state = optimizer.init(leaves)

    def loss_fn(params, spikes, labels):
        if qat_net is not None:
            rec = qat_lib.run_qat(qat_net, params, spikes, spike_fn)
        else:
            rec = run_float(net, params, spikes, spike_fn)
        total = sum(s.sum() for s in rec.layer_spikes) / spikes.shape[1]
        loss = spike_count_loss(rec.spike_counts, labels, rate_reg, total)
        acc = (rec.predictions() == labels).to(torch.float32).mean()
        return loss, acc

    rng = np.random.default_rng(seed)
    history = []
    with full_f32_matmul():
        for epoch in range(epochs):
            t0 = time.time()
            losses, accs = [], []
            for spikes, labels in train_ds.batches(eff_batch, rng):
                x, y = _float_batch(spikes, labels, dev)
                leaves, opt_state, loss, acc = _train_step(
                    lambda p: loss_fn(p, x, y), optimizer, leaves, opt_state
                )
                losses.append(loss)
                accs.append(acc)
            # one read of the epoch's losses: no host wait inside the epoch
            losses = torch.stack(losses).cpu().numpy().astype(np.float64)
            accs = torch.stack(accs).cpu().numpy().astype(np.float64)
            entry = {
                "epoch": epoch,
                "loss": float(np.mean(losses)),
                "train_acc": float(np.mean(accs)),
                "seconds": time.time() - t0,
            }
            if eval_ds is not None:
                if qat_net is not None:
                    entry["eval_acc"] = qat_lib.eval_qat(
                        qat_net, _layers(leaves), eval_ds, surrogate_slope
                    )
                else:
                    entry["eval_acc"] = eval_float(net, _layers(leaves), eval_ds, surrogate_slope)
            history.append(entry)
            if log_every and (epoch % log_every == 0 or epoch == epochs - 1):
                print(f"[train_snn:{net.name}] {entry}")
    return TrainResult(params=_layers(leaves), history=history, net=net, qat_net=qat_net)


def eval_float(
    net,
    params,
    ds: SpikeDataset,
    surrogate_slope: float = 25.0,
    batch_size: int = 256,
    backend="reference",
    mesh=None,
) -> float:
    """Accuracy of the float model on the parameters' device.

    ``mesh`` (``None`` | ``"auto"`` | int | ``repro_torch.core.shard.
    DeviceMesh``) spreads each batch's sample axis across the mesh's devices
    (``shard.run_float_sharded``).  A float product over a shard's rows may
    round differently from one over the whole batch, so a spike threshold
    can flip on one ulp and the accuracy move by a sample.
    """
    spike_fn = fast_sigmoid(surrogate_slope)
    dmesh = shard_lib.resolve_mesh(mesh)
    device = params[0].w_ff.device
    correct = total = 0
    with torch.no_grad(), full_f32_matmul():
        for spikes, labels in ds.batches(batch_size):
            x = raster_tensor(spikes, device).to(torch.float32)
            rec = shard_lib.run_float_sharded(net, params, x, spike_fn, dmesh, backend=backend)
            preds = rec.predictions()
            correct += int((preds.cpu().numpy() == labels).sum())
            total += len(labels)
    return correct / max(1, total)


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
    ``backend`` is a speed knob, not an accuracy knob.

    ``mesh`` (``None`` | ``"auto"`` | int | ``repro_torch.core.shard.
    DeviceMesh``) spreads each batch's sample axis across the mesh's devices
    -- bit-exact with the serial path (see ``repro_torch.core.shard``); the
    statistics are taken over the reassembled batch, as the serial path
    takes them.  ``backend="event"`` shards through its fixed-capacity
    surrogate; an explicit ``EventBackend("csr")`` warns and runs serially.
    """
    resolved = backend_lib.get_backend(backend)
    dmesh = shard_lib.resolve_mesh(mesh)
    device = qparams[0].w_ff.device

    correct = total = 0
    layer_ev = None
    in_ev = None
    for spikes, labels in work.spanned(ds.batches(batch_size), "eval.gather"):
        with work.span("eval.h2d"):
            x = raster_tensor(spikes, device)
        rec = shard_lib.run_int_sharded(net, qparams, x, dmesh, backend=resolved)
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


def _population_fwd(net, stacked_qparams, beta_regs, alpha_regs, spikes, dmesh=None):
    """One data batch of the sweep (its candidate axis across ``dmesh``):
    [P, batch] predictions, [P, T, L] batch-mean emitted events and [T]
    batch-mean input events (numpy float32, as JAX's ``jnp.mean`` computes
    them: ``sum * fl32(1/batch)``)."""
    with work.span("population.forward"):
        counts, emitted = shard_lib.run_int_population_sharded(
            net, stacked_qparams, beta_regs, alpha_regs, spikes, dmesh, return_events=True
        )
    with work.span("population.readback"):
        P, T, L, B = emitted.shape
        evs = _batch_mean(emitted.reshape(P * T * L, B)).reshape(P, T, L)
        iev = _batch_mean(backend_lib._count(spikes != 0))
        return torch.argmax(counts, dim=-1).cpu().numpy(), evs, iev


def eval_int_population(
    net,
    candidate_nets: Sequence[NetworkConfig],
    qparams_list: Sequence[list],
    ds: SpikeDataset,
    batch_size: int = 256,
    return_stats: bool = False,
    mesh=None,
):
    """Bit-exact accuracies for a population of precision candidates at once.

    All candidates share ``net``'s static structure (the DSE varies only
    quantized values and CG decay registers), so one sweep
    (:func:`~repro_torch.core.backend.run_int_population`) scores the whole
    population per data batch, on the parameters' device.

    Returns a float accuracy per candidate (numpy float64), identical to
    calling :func:`eval_int` per candidate.  With ``return_stats``, also one
    per-candidate event-traffic dict of the same shape as ``eval_int(...,
    return_stats=True)`` (numpy float32, bit-identical to JAX's sweep) --
    each candidate quantizes differently and therefore spikes differently,
    which is what the event-aware DSE cost needs to see.

    ``mesh`` spreads the *candidate* axis across devices (the DSE fan-out):
    each shard sweeps its slice of the population, so per-candidate results
    stay bit-exact with the one-device sweep and with serial
    :func:`eval_int` (see ``repro_torch.core.shard``).

    The whole call is the span ``population.sweep``; inside it
    ``population.check``, ``population.stack``, and a ``population.batch``
    a data batch (after its gather) holding ``population.h2d``,
    ``population.forward`` (the kernels' spans below it, and a
    ``population.step_loop`` a layer stepped in PyTorch) and
    ``population.readback``; then ``population.stats``.
    """
    with work.span("population.sweep"):
        backend_lib.check_population_structure(net, candidate_nets)
        dmesh = shard_lib.resolve_mesh(mesh)
        stacked, beta_regs, alpha_regs = backend_lib.stack_population(candidate_nets, qparams_list)
        device = beta_regs.device

        P = len(candidate_nets)
        correct = np.zeros(P, np.int64)
        total = 0
        layer_ev = None  # [P, T, L] running size-weighted sum of batch means
        in_ev = None  # [T]
        for spikes, labels in ds.batches(batch_size):
            with work.span("population.batch"):
                with work.span("population.h2d"):
                    x = raster_tensor(spikes, device)
                preds, evs, iev = _population_fwd(net, stacked, beta_regs, alpha_regs, x, dmesh)
                correct += (preds == labels[None, :]).sum(axis=1)
                n = len(labels)
                total += n
                # size-weighted like eval_int: partial batches must not bias traffic
                evs, iev = evs * n, iev * n
                layer_ev = evs if layer_ev is None else layer_ev + evs
                in_ev = iev if in_ev is None else in_ev + iev
        accs = correct / max(1, total)
        if not return_stats:
            return accs
        with work.span("population.stats"):
            layer_ev = layer_ev / max(1, total)
            in_ev = in_ev / max(1, total)
            stats = [
                {
                    "input_events_per_step": in_ev,
                    "layer_events_per_step": [layer_ev[p, :, l] for l in range(layer_ev.shape[2])],
                }
                for p in range(P)
            ]
        return accs, stats
