"""Quantization-aware training (QAT) for Flexi-NeurA networks (port of
``repro/snn/qat.py``).

A straight-through-estimator (STE) fake-quant forward whose defining
property is: the QAT forward's values ARE the deployment datapath's values.
Every forward intermediate comes from the same int32 phase-A / phase-B code
the inference backends run (``snn_layer.int_phase_a`` / ``int_phase_b``; on
the card phase A is a ``spike_matmul`` launch), with the quantization scale
from the same ``network.layer_scale`` arithmetic ``quantize_params`` uses.
So a QAT-trained network deploys through the unchanged ``quantize_params``
-> ``eval_int`` path, and the training-time evaluation equals ``eval_int``
bit for bit.

Gradients come from a float *mirror* of each step (``torch.matmul`` for the
products) glued on with the straight-through identity ``exact + (approx -
approx.detach())``: the forward value is the exact integer result, the
backward graph is the smooth float approximation (surrogate spike gradient
through the rescaled membrane argument, multiplicative ``k/256`` decay in
place of the CG's floor-shift cascade, pass-through rounding/saturation).
Integer tensors never enter autograd's graph.

Two entry points:

* :func:`run_qat` -- the fake-quant forward (what ``train_snn(qat=...)``
  differentiates).  Decay registers and weight-grid maxima default to the
  network config but may be tensors; with parameters stacked on a leading
  candidate axis [K, ...] it runs K precision candidates at once.
* :func:`refine_candidates` -- the Flex-plorer's second-phase refinement:
  fine-tune a population of precision candidates at once.  Where JAX vmaps
  the train step, every tensor here carries an explicit candidate axis:
  each step's phase A is one ``spike_matmul`` launch per layer over all K
  candidates (layer 0's shared raster with stride 0), the loss is the sum of
  the candidates' losses (one ``backward`` gives each its own gradient),
  each candidate is clipped by its own global norm, and one AdamW step
  updates the stacks.  Scoring is the bit-exact ``eval_int_population``
  once per epoch, epoch -1 (the unrefined post-training quantization)
  included, and each candidate keeps its best checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import full_f32_matmul
from repro_torch.core import coeff_gen
from repro_torch.core import shard as shard_lib
from repro_torch.core.backend import SimRecord, check_population_structure
from repro_torch.core.fixed_point import int_max, saturate
from repro_torch.core.network import NetworkConfig, layer_scale, quantize_params
from repro_torch.core.snn_layer import (
    FloatLayerParams,
    IntLayerParams,
    LayerState,
    NeuronModel,
    ResetMode,
    Topology,
    int_phase_a,
    int_phase_b,
)
from repro_torch.data.snn_datasets import raster_tensor
from repro_torch.snn.surrogate import fast_sigmoid
from repro_torch.train import optimizer as opt_lib

__all__ = [
    "PrecisionConfig",
    "FakeQuantLayer",
    "fake_quant_layer",
    "run_qat",
    "eval_qat",
    "RefineResult",
    "refine_candidates",
    # the port's own: the candidate-axis train step JAX writes as a vmap
    "candidate_grid",
    "refine_step",
]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """The precision a network should be quantization-aware-trained *for*.

    ``None`` keeps the network's current value for that knob (the same
    semantics as ``NetworkConfig.replace_precisions``).
    """

    w_bits: int | None = None
    w_rec_bits: int | None = None
    leak_bits: int | None = None

    def apply(self, net: NetworkConfig) -> NetworkConfig:
        return net.replace_precisions(
            w_bits=self.w_bits, w_rec_bits=self.w_rec_bits, leak_bits=self.leak_bits
        )


class FakeQuantLayer(NamedTuple):
    """STE-quantized per-core parameters, in the scaled integer domain.

    float32 tensors holding exactly-integer values equal to the matching
    ``IntLayerParams`` from ``quantize_params`` at the same precision;
    gradients flow back to the float parameters through the straight-through
    round (d round(w * s) / d w = s).  With a candidate axis each field leads
    with K.
    """

    w_ff: torch.Tensor  # f32 [n_in, n_out], integer-valued
    w_rec: torch.Tensor  # f32 [n_out, n_out] | scalar | [0], integer-valued
    theta_q: torch.Tensor  # f32 scalar, integer-valued
    scale: torch.Tensor  # f32 scalar, no gradient


def _ste_round(x):
    """Round-half-to-even forward, identity gradient."""
    return x + (torch.round(x) - x).detach()


def _ste_exact(int_value, approx):
    """Forward: the exact int32 value.  Backward: the float mirror's gradient.

    The straight-through glue between the deployment datapath and the
    differentiable mirror; the integer tensor stays out of the graph.
    """
    return int_value.to(f32).detach() + (approx - approx.detach())


def _decay_factor(decay_register):
    """The CG's nominal multiplicative factor for a packed DecayRate register
    (an int32 tensor) or a static :class:`~repro_torch.core.coeff_gen.DecayCode`."""
    if isinstance(decay_register, coeff_gen.DecayCode):
        return decay_register.factor  # k / 256, exact in float32
    return torch.where(decay_register >= 256, 1.0, decay_register.to(f32) / 256.0)


def _decay_fn(decay_register):
    """The exact CG application: the static shift set of a DecayCode, or the
    arithmetically gated taps of a register tensor (one value per
    candidate); both give the same bits."""
    if isinstance(decay_register, coeff_gen.DecayCode):
        return lambda x: coeff_gen.apply_decay(x, decay_register)
    return lambda x: coeff_gen.apply_decay_traced(x, decay_register)


def _lead(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A per-candidate value ([] or [K]) shaped to broadcast against ``ref``."""
    return t.reshape(t.shape + (1,) * (ref.dim() - t.dim()))


def _clip(x, lo, hi):
    # jnp.clip's form: at a bound each side takes half the gradient
    return torch.minimum(torch.maximum(x, lo), hi)


def fake_quant_layer(cfg, p: FloatLayerParams, w_max=None, rec_max=None) -> FakeQuantLayer:
    """Fake-quantize one core's float parameters onto its fixed-point grid.

    Mirrors ``network.quantize_params`` exactly: same ``layer_scale``, same
    round-half-to-even, same clip bounds -- the returned integer-valued
    floats equal the deployed ``IntLayerParams`` bit for bit.  ``w_max`` /
    ``rec_max`` (defaults ``int_max(w_bits)`` / ``int_max(w_rec_bits)``) may
    be tensors of shape [K] with ``p`` stacked on a candidate axis, so
    candidates of different weight bit-widths run in one call.
    """
    dev = p.w_ff.device
    w_max = torch.as_tensor(int_max(cfg.w_bits) if w_max is None else w_max, dtype=f32).to(dev)
    rec_max = torch.as_tensor(
        int_max(cfg.w_rec_bits) if rec_max is None else rec_max, dtype=f32
    ).to(dev)
    with torch.no_grad():
        scale = layer_scale(cfg, p, w_max, rec_max)
    s_ff, m_ff = _lead(scale, p.w_ff), _lead(w_max, p.w_ff)
    w_ff = _clip(_ste_round(p.w_ff * s_ff), -m_ff - 1.0, m_ff)
    if cfg.topology in (Topology.ATA_T, Topology.ATA_F):
        s_rec, m_rec = _lead(scale, p.w_rec), _lead(rec_max, p.w_rec)
        w_rec = _clip(_ste_round(p.w_rec * s_rec), -m_rec - 1.0, m_rec)
    else:
        w_rec = torch.zeros(p.w_rec.shape, dtype=f32, device=dev)
    theta_q = _ste_round(p.theta * scale)
    return FakeQuantLayer(w_ff=w_ff, w_rec=w_rec, theta_q=theta_q, scale=scale)


def _int_params(fq: FakeQuantLayer) -> IntLayerParams:
    """The deployment parameters a FakeQuantLayer's values are, as int32."""
    return IntLayerParams(
        w_ff=fq.w_ff.detach().to(torch.int32).contiguous(),
        w_rec=fq.w_rec.detach().to(torch.int32).contiguous(),
        theta_q=fq.theta_q.detach().to(torch.int32),
    )


def _qat_layer_step(
    cfg, fq: FakeQuantLayer, state: LayerState, s_in, spike_fn, beta_reg, alpha_reg, qint=None
):
    """One QAT time step: exact int32 forward, float-mirror backward.

    ``beta_reg`` / ``alpha_reg``: int32 register tensors (scalar, or [K, 1,
    1] with a candidate axis) or the config's static DecayCodes.  ``state``
    carries float32 tensors whose values are the exact integer registers;
    the returned state has the same property (each leaf is
    ``_ste_exact``-pinned to the deployment step's output).  ``qint`` is
    ``_int_params(fq)``, passed in so a window converts it once.
    """
    if qint is None:
        qint = _int_params(fq)
    state_i = LayerState(*(t.to(torch.int32) for t in state))
    s_in_f = s_in.to(f32)

    # --- phase A: exact integration through the deployment code path ---
    u_i, isyn_i = int_phase_a(cfg, qint, state_i, s_in_f)
    # float mirror of the same accumulation
    acc_f = torch.matmul(s_in_f, fq.w_ff)
    if cfg.topology == Topology.ATA_T:
        acc_f = acc_f + torch.matmul(state.prev_spk, fq.w_rec)
    elif cfg.topology == Topology.ATA_F:
        acc_f = acc_f + state.prev_spk * fq.w_rec
    if cfg.neuron == NeuronModel.SYNAPTIC:
        u = _ste_exact(u_i, state.u)
        i_syn = _ste_exact(isyn_i, state.i_syn + acc_f)
    else:
        # the synaptic register is untouched (zeros, as in the int path)
        u, i_syn = _ste_exact(u_i, state.u + acc_f), state.i_syn

    # --- phase B: exact spike/reset/leak ---
    state_i2, spk_i = int_phase_b(
        cfg, qint, u_i, isyn_i, _decay_fn(beta_reg), _decay_fn(alpha_reg)
    )
    if cfg.neuron == NeuronModel.SYNAPTIC:
        u_tmp = _ste_exact(saturate(u_i + isyn_i, cfg.u_bits), u + i_syn)
    else:
        u_tmp = u
    # Surrogate spike on the *descaled* membrane argument: the Heaviside
    # forward is the exact integer comparison (scale > 0 preserves sign),
    # while the surrogate's slope sees float-domain magnitudes.
    inv_scale = 1.0 / fq.scale
    spk = spike_fn((u_tmp - fq.theta_q) * inv_scale)
    if cfg.reset == ResetMode.ZERO:
        u_reset = torch.zeros_like(u_tmp)
    else:
        u_reset = u_tmp - fq.theta_q
    u_new_f = spk * u_reset + (1.0 - spk) * (_decay_factor(beta_reg) * u_tmp)
    u_new = _ste_exact(state_i2.u, u_new_f)
    if cfg.neuron == NeuronModel.SYNAPTIC:
        i_new = _ste_exact(state_i2.i_syn, _decay_factor(alpha_reg) * i_syn)
    else:
        i_new = i_syn
    spk = _ste_exact(spk_i, spk)  # forward pinned to the int path, surrogate grad kept
    return LayerState(u=u_new, i_syn=i_new, prev_spk=spk), spk


def _per_candidate(fq: FakeQuantLayer) -> FakeQuantLayer:
    """A stacked layer's per-candidate scalars as [K, 1, 1], to broadcast
    against the state [K, batch, n_out]."""
    col = lambda t: t.reshape(-1, 1, 1)
    w_rec = col(fq.w_rec) if fq.w_rec.dim() == 1 else fq.w_rec
    return FakeQuantLayer(fq.w_ff, w_rec, col(fq.theta_q), col(fq.scale))


def run_qat(
    net: NetworkConfig,
    params: Sequence[FloatLayerParams],
    spikes_in,
    spike_fn,
    *,
    w_maxes=None,
    rec_maxes=None,
    beta_regs=None,
    alpha_regs=None,
) -> SimRecord:
    """Differentiable fake-quant simulation at ``net``'s precisions.

    ``spikes_in``: {0,1} [T, batch, n_in] on the parameters' device.
    Returns a :class:`SimRecord` whose ``spike_counts`` are float32
    *integer-valued* logits equal, bit for bit, to ``run_int(net,
    quantize_params(net, params)[0], spikes_in)`` -- while carrying surrogate
    gradients back to ``params``.

    The keyword tensors override the per-layer quantization grid
    (``w_maxes`` / ``rec_maxes``: float32 ``[n_layers]`` weight-grid maxima;
    ``beta_regs`` / ``alpha_regs``: int32 ``[n_layers]`` packed DecayRate
    registers); they default to ``net``'s config.  With ``params`` stacked
    on a leading candidate axis (``w_ff`` [K, n_in, n_out]) they are [K,
    n_layers], the raster stays shared, and every output leads with K:
    ``spike_counts`` [K, batch, n_classes], ``layer_spikes`` [K, T, batch].
    """
    stacked = params[0].w_ff.dim() == 3
    dev = params[0].w_ff.device
    pick = lambda a, i: None if a is None else a[..., i]
    fq_layers = [
        fake_quant_layer(cfg, p, pick(w_maxes, i), pick(rec_maxes, i))
        for i, (cfg, p) in enumerate(zip(net.layers, params))
    ]
    if stacked:
        fq_layers = [_per_candidate(fq) for fq in fq_layers]
    qints = [_int_params(fq) for fq in fq_layers]

    def regs(given, codes):
        if given is None:  # the config's codes: static shift sets
            return codes
        return [given[..., i].reshape((-1, 1, 1) if stacked else ()) for i in range(len(codes))]

    betas = regs(beta_regs, [cfg.beta_code() for cfg in net.layers])
    alphas = regs(alpha_regs, [cfg.alpha_code() for cfg in net.layers])

    spikes_f = spikes_in.to(f32)
    lead = (params[0].w_ff.shape[0],) if stacked else ()
    batch = spikes_f.shape[1]

    def zeros(cfg):
        return torch.zeros(lead + (batch, cfg.n_out), dtype=f32, device=dev)

    states = [LayerState(zeros(cfg), zeros(cfg), zeros(cfg)) for cfg in net.layers]
    out_spikes, emitted = [], [[] for _ in net.layers]
    for s_t in spikes_f:
        x = s_t
        for i, (cfg, fq) in enumerate(zip(net.layers, fq_layers)):
            states[i], x = _qat_layer_step(
                cfg, fq, states[i], x, spike_fn, betas[i], alphas[i], qints[i]
            )
            emitted[i].append(x.sum(dim=-1))
        out_spikes.append(x)
    counts = torch.stack(out_spikes).sum(dim=0)
    return SimRecord(
        spike_counts=counts,
        layer_spikes=[torch.stack(e, dim=-2) for e in emitted],
        input_events=(spikes_in != 0).sum(dim=-1, dtype=torch.int32),
    )


def eval_qat(
    net: NetworkConfig,
    params,
    ds,
    surrogate_slope: float = 25.0,
    batch_size: int = 256,
) -> float:
    """Accuracy of the QAT forward on the parameters' device -- equal to
    ``eval_int`` after ``quantize_params`` at the same precisions (the
    parity contract)."""
    spike_fn = fast_sigmoid(surrogate_slope)
    device = params[0].w_ff.device
    correct = total = 0
    with torch.no_grad():
        for spikes, labels in ds.batches(batch_size):
            preds = run_qat(net, params, raster_tensor(spikes, device), spike_fn).predictions()
            correct += int((preds.cpu().numpy() == labels).sum())
            total += len(labels)
    return correct / max(1, total)


# ---------------------------------------------------------------------------
# Population refinement: fine-tune the search's finalists at their own grids
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RefineResult:
    """Per-candidate outcome of a population QAT fine-tune.

    ``params[k]`` is candidate k's best float checkpoint (by bit-exact
    quantized accuracy on the scoring set, the unrefined input included),
    ``best_acc[k]`` that checkpoint's accuracy and ``base_acc[k]`` the
    post-training-quantization accuracy -- so ``best_acc >= base_acc``
    elementwise by construction.
    """

    candidates: list[NetworkConfig]
    params: list
    best_acc: np.ndarray
    base_acc: np.ndarray
    history: list[dict]


def candidate_grid(candidates: Sequence[NetworkConfig], device) -> tuple:
    """Each candidate's quantization grid as :func:`run_qat`'s keyword
    tensors on ``device``: ``(w_maxes, rec_maxes, beta_regs, alpha_regs)``,
    float32 / float32 / int32 / int32 [K, n_layers]."""

    def table(fn, dtype):
        rows = [[fn(lc) for lc in cn.layers] for cn in candidates]
        return torch.tensor(rows, dtype=dtype).to(device)

    return (
        table(lambda lc: int_max(lc.w_bits), f32),
        table(lambda lc: int_max(lc.w_rec_bits), f32),
        table(lambda lc: lc.beta_code().decay_rate_register, torch.int32),
        table(lambda lc: lc.alpha_code().decay_rate_register, torch.int32),
    )


def refine_step(net, optimizer, leaves, opt_state, grid, spikes, labels, spike_fn, rate_reg):
    """One QAT train step of every candidate at once (the step JAX vmaps).

    ``leaves``: the stacked float parameters in tree order (per layer
    ``w_ff`` [K, n_in, n_out], ``w_rec``, ``theta`` [K]); ``grid``: the
    per-candidate ``(w_maxes, rec_maxes, beta_regs, alpha_regs)`` of
    :func:`candidate_grid`; ``spikes`` float32 [T, batch, n_in] shared by all.  Each
    candidate gets the gradient of its own loss, clipped by its own global
    norm, and one AdamW step.  Returns ``(leaves, opt_state, loss [K], acc
    [K])``.  On the card, phase A of every time step is one ``spike_matmul``
    launch per layer for all K candidates.
    """
    from repro_torch.snn.train import _train_step, spike_count_loss

    w_maxes, rec_maxes, beta_regs, alpha_regs = grid

    def loss_fn(params):
        rec = run_qat(
            net, params, spikes, spike_fn,
            w_maxes=w_maxes, rec_maxes=rec_maxes, beta_regs=beta_regs, alpha_regs=alpha_regs,
        )
        total = sum(s.sum(dim=(-2, -1)) for s in rec.layer_spikes) / spikes.shape[1]
        loss = spike_count_loss(rec.spike_counts, labels, rate_reg, total)
        acc = (rec.predictions() == labels).to(f32).mean(dim=-1)
        return loss, acc

    return _train_step(loss_fn, optimizer, leaves, opt_state, batch_dims=1)


def refine_candidates(
    net: NetworkConfig,
    candidates: Sequence[NetworkConfig],
    float_params: Sequence[FloatLayerParams],
    train_ds,
    eval_ds,
    *,
    epochs: int = 2,
    batch_size: int = 128,
    lr: float = 5e-4,
    seed: int = 0,
    surrogate_slope: float = 25.0,
    rate_reg: float = 1e-4,
    eval_batch: int = 512,
    mesh=None,
) -> RefineResult:
    """Fine-tune ``float_params`` at each candidate's precision, in parallel,
    on the parameters' device.

    All candidates train simultaneously through :func:`refine_step` (stacked
    parameters, per-candidate grid maxima and decay registers; batches from
    ``np.random.default_rng(seed)`` as in JAX).  Scoring is always the
    bit-exact quantized path (``eval_int_population``), once per epoch and
    once before the first, and each candidate keeps its best checkpoint --
    refinement can reorder but never lose accuracy against post-training
    quantization on the scoring set.

    ``mesh`` (``None`` | ``"auto"`` | int | ``repro_torch.core.shard.
    DeviceMesh``) splits the candidate axis across the mesh's devices, as
    JAX's ``shard_map`` of the vmapped step does: the candidates are
    edge-padded to the shard multiple, each shard takes its slice's train
    steps (its own optimizer state) on its device, and scoring sweeps the
    unpadded candidates over the same mesh.  A candidate's gradient is its
    own loss's, so sharding changes no candidate's arithmetic except where a
    float product's summation order depends on how many candidates it
    batches; scores are unaffected (they come from the int32 evaluator).
    """
    # Lazy import: repro_torch.snn.train imports this module.
    from repro_torch.snn.train import _float_batch, _layers, _leaves, eval_int_population

    candidates = list(candidates)
    check_population_structure(net, candidates)
    n_cand = len(candidates)
    dev = float_params[0].w_ff.device
    dmesh = shard_lib.resolve_mesh(mesh)
    sharded = dmesh is not None and dmesh.n_shards > 1
    n_shards = dmesh.n_shards if sharded else 1
    padded_n = -(-n_cand // n_shards) * n_shards
    padded = candidates + [candidates[-1]] * (padded_n - n_cand)

    grid = candidate_grid(padded, dev)
    stacked = [torch.stack([t] * padded_n) for t in _leaves(float_params)]
    if sharded:  # one slice of the candidate axis per shard, on its device
        cut = lambda ts: [list(p) for p in zip(*(shard_lib.split(t, dmesh, 0) for t in ts))]
        shards, grids, devices = cut(stacked), [tuple(g) for g in cut(grid)], dmesh.devices
    else:
        shards, grids, devices = [stacked], [grid], (dev,)

    spike_fn = fast_sigmoid(surrogate_slope)
    n_train = len(train_ds.labels)
    eff_batch = min(batch_size, n_train)
    steps_per_epoch = max(1, -(-n_train // eff_batch))
    optimizer = opt_lib.adamw(
        opt_lib.linear_warmup_cosine(lr, steps_per_epoch, max(1, epochs) * steps_per_epoch)
    )
    opt_states = [optimizer.init(s) for s in shards]

    def gathered(shards):
        """The unpadded candidates' stacked leaves on the parameters' device."""
        if not sharded:
            return shards[0]
        return [
            shard_lib.join([s[j] for s in shards], dmesh, 0)[:n_cand].to(dev)
            for j in range(len(shards[0]))
        ]

    def candidate(leaves, k):
        return _layers([t[k] for t in leaves])

    def score(leaves):
        """Bit-exact quantized accuracy per candidate."""
        qparams_list = [
            quantize_params(c, candidate(leaves, k))[0] for k, c in enumerate(candidates)
        ]
        return np.asarray(
            eval_int_population(
                net, candidates, qparams_list, eval_ds, batch_size=eval_batch, mesh=dmesh
            )
        )

    best = gathered(shards)
    base_acc = score(best)
    best_acc = base_acc.copy()
    history = [{"epoch": -1, "acc": base_acc.tolist()}]

    rng = np.random.default_rng(seed)
    with full_f32_matmul():
        for epoch in range(epochs):
            for spikes, labels in train_ds.batches(eff_batch, rng):
                x, y = _float_batch(spikes, labels, dev)
                batch = {d: (x.to(d), y.to(d)) for d in dict.fromkeys(devices)}
                for i, d in enumerate(devices):
                    shards[i], opt_states[i], _, _ = refine_step(
                        net, optimizer, shards[i], opt_states[i], grids[i], *batch[d],
                        spike_fn, rate_reg,
                    )
            leaves = gathered(shards)
            accs = score(leaves)
            history.append({"epoch": epoch, "acc": accs.tolist()})
            improved = accs > best_acc
            if improved.any():
                mask = torch.from_numpy(improved).to(dev)
                best = [
                    torch.where(mask.reshape((-1,) + (1,) * (h.dim() - 1)), h, b)
                    for b, h in zip(best, leaves)
                ]
                best_acc = np.where(improved, accs, best_acc)

    return RefineResult(
        candidates=candidates,
        params=[candidate(best, k) for k in range(n_cand)],
        best_acc=best_acc,
        base_acc=base_acc,
        history=history,
    )
