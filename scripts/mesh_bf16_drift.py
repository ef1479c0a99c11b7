#!/usr/bin/env python3
"""Why ``chip_smoke.py`` phase 17 replays one device's MoE routes on the
mesh and checks jamba's and mamba2's serving at f32 compute, on one card.

    python3 scripts/mesh_bf16_drift.py   # one card, ~2 min

The seeds and shapes of phase 17 on its (2, 2) mesh of four shards of card
0.  Prints, each line with the card's name and power limit:

1. granite-moe-1b-a400m at full width, f32 compute, seq 256 x batch 8: the
   gradients of the loss on the mesh against one device's, the mesh routing
   by its own top k, then replaying one device's routes
   (``models/routing_probe.py::record_routing``): the worst leaves, the
   tokens the mesh's own top k routes elsewhere and their margins;
2. jamba-v0.1-52b at full width cut to one 8-layer group (phase 14's cut)
   and mamba2-780m's 48 layers, int8 serve_optimized weights: a prefill's
   logits (2 x 4096 tokens, 2 x 512) on one device at bf16 against f32
   compute, and the mesh's against one device's at each, the one device's
   routes replayed; and a second witness of the bf16 spread with no mesh in
   it: one device at bf16 with the SSD's chunk halved (the same function,
   its sums in another order, the routes replayed) against the chunk of
   the config.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.models.routing_probe import record_routing  # noqa: E402


def dist(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def granite_gradients(mesh, smi: str) -> None:
    arch = cs.get_arch(cs.MOE_ARCH)
    cfg = dataclasses.replace(arch.config, compute_dtype=torch.float32)
    shape = cs.ShapeSpec("train", cs.TRAIN_SEQ, cs.TRAIN_BATCH, "train")
    batch = cs.train_batches(arch, cfg, 1)[0]
    init = lambda: arch.init_params(torch.Generator(device=cs.DEVICE).manual_seed(0), cfg)
    loss_fn = arch.loss_fn(cfg)
    params = init()
    paths = [p for p, _ in cs.tree_leaves(params)]
    leaves = [t.detach().requires_grad_(True) for _, t in cs.tree_leaves(params)]
    with record_routing(keep=True) as kept:
        loss, _ = loss_fn(cs.tree_unflatten(params, leaves), batch)
        g_one = list(torch.autograd.grad(loss, leaves))
    del leaves, loss, params
    sp = cs.shard_tree(init(), arch.param_pspecs(mesh, cfg), mesh)
    b_specs = arch.input_pspecs(mesh, shape, cfg)
    placed = {k: cs.place(v, b_specs[k], mesh) for k, v in batch.items()}
    for how, replay in (("its own routing", None), ("one device's routes replayed", kept["routes"])):
        with record_routing(replay=replay) as rec:
            _, _, g = cs.mesh_value_and_grad(loss_fn, sp, placed)
        worst = sorted(((cs.leaf_err(x.full(), w), p) for x, w, p in zip(g, g_one, paths)), reverse=True)[:3]
        flips = (f"; its own top k routes {rec['flips']} token routings elsewhere, largest margin / "
                 f"twice the probabilities' change {rec['flip_ratio']:.3e}" if replay else "")
        print(f"granite f32 gradients, mesh with {how}: worst leaves "
              f"{[(p, f'{e:.3e}') for e, p in worst]} of max |g|{flips}; one device's smallest top-k "
              f"margin {kept['margin']:.3e}; on {smi}", flush=True)
    del sp, placed, g, g_one
    torch.cuda.empty_cache()


def prefill_drift(name: str, n_layers: int, S: int, mesh, smi: str) -> None:
    arch = cs.get_arch(name)
    cfg = dataclasses.replace(arch.config, n_layers=n_layers)
    arch = dataclasses.replace(arch, config=cfg)
    qparams = cs.quantize_tree(cs.init_bf16(arch, cfg), cs.lm_policy(8))
    tokens = torch.from_numpy(cs.np.random.default_rng(18).integers(0, cfg.vocab, (2, S))).to(cs.DEVICE)
    shape = cs.ShapeSpec("prefill", S, 2, "prefill")
    kw = dict(quant=cs.lm_policy(8), serve_optimized=True)
    cfgs = {"bf16": cfg, "f32": dataclasses.replace(cfg, compute_dtype=torch.float32)}
    half = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=cfg.ssm.chunk // 2))
    logits, routes = {}, {}
    with torch.no_grad():
        for k, c in cfgs.items():
            with record_routing(keep=True) as rec:
                logits[k] = cs.build_prefill_step(arch, shape, None, c, **kw).jitted(qparams, {"tokens": tokens})[0]
            routes[k] = rec["routes"]
        with record_routing(replay=routes["bf16"]):
            logits["half"] = cs.build_prefill_step(arch, shape, None, half, **kw).jitted(
                qparams, {"tokens": tokens})[0]
        for k, c in cfgs.items():  # the first mesh call places the tree: one device's copy goes
            with record_routing(replay=routes[k]):
                logits["mesh " + k] = cs.build_prefill_step(arch, shape, mesh, c, **kw).jitted(
                    qparams, {"tokens": tokens})[0]
    print(f"{name} ({n_layers} layers, 2 x {S} prefill, int8 serve_optimized): one device bf16 vs "
          f"f32 compute {dist(logits['bf16'], logits['f32']):.3e} of max |logit|; the mesh vs one "
          f"device at bf16 {dist(logits['mesh bf16'], logits['bf16']):.3e}, at f32 "
          f"{dist(logits['mesh f32'], logits['f32']):.3e}; one device at bf16 with the SSD chunk "
          f"{half.ssm.chunk} vs {cfg.ssm.chunk} {dist(logits['half'], logits['bf16']):.3e}; on {smi}",
          flush=True)
    del qparams, logits
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_bf16_drift: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cs.build.load_all()
    mesh = cs.card_mesh2(cs.MESH_SHAPE)
    granite_gradients(mesh, smi)
    prefill_drift(cs.HYBRID_ARCH, 8, cs.MESH_PREFILL_S, mesh, smi)
    prefill_drift(cs.SSM_ARCH, cs.get_arch(cs.SSM_ARCH).config.n_layers, cs.MESH17_SSM_PROMPT, mesh, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
