"""End-to-end LM training on the port: a ~100M-parameter stablelm-family
model trained for a few hundred steps with the production loop -- the host
mesh, checkpoints, automatic resume, straggler telemetry, and an injected
node failure it recovers from.

    PYTHONPATH=src python examples_torch/lm_train_100m.py [--steps 300]               # on the card
    PYTHONPATH=src python examples_torch/lm_train_100m.py --device cpu --steps 120

A second run on the same ``--run-dir`` resumes from its LATEST checkpoint.
The default run directory, ``runs/lm100m_torch``, lies beside the JAX
example's ``runs/lm100m``, whose checkpoints are of another format.  The
weights and token batches start from seed 0 of the port's generators, not
from ``jax.random``, so the losses differ from the JAX example's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import torch

from repro_torch._device import device_label, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import get_arch
from repro_torch.train.loop import TrainLoop

ARCH = "stablelm-1.6b"


def config_100m():
    """~100M config of the stablelm family: 12 x 512 with the arch's
    MHA / rope_frac, d_ff 1408, vocab 8192."""
    return dataclasses.replace(
        get_arch(ARCH).reduced_config,
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=8, d_head=64, d_ff=1408, vocab=8192,
    )


def n_params(cfg) -> int:
    return sum(math.prod(s.shape) for _, s in tree_leaves(get_arch(ARCH).template(cfg)))


def train(cfg, steps: int = 300, run_dir: str = "runs/lm100m_torch",
          device: str | torch.device = "cuda", seq_len: int = 256, global_batch: int = 8) -> dict:
    """``TrainLoop`` over ``make_host_mesh(device)`` for ``steps`` steps, a
    checkpoint every 50, a node failure injected at ``steps // 2``."""
    dev = resolve_device(device)
    loop = TrainLoop(
        arch_name=ARCH,
        seq_len=seq_len,
        global_batch=global_batch,
        mesh=make_host_mesh(dev),
        run_dir=run_dir,
        ckpt_every=50,
        log_every=10,
        fail_at_step=steps // 2,  # prove the restart path mid-run
        device=str(dev),
    )
    loop.arch = dataclasses.replace(loop.arch, reduced_config=cfg)
    loop.cfg = cfg
    t0 = time.perf_counter()
    out = loop.run(total_steps=steps)
    out["wall_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--run-dir", default="runs/lm100m_torch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = config_100m()
    print(f"model: stablelm-family {n_params(cfg) / 1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model} ff={cfg.d_ff} vocab={cfg.vocab})")
    out = train(cfg, args.steps, args.run_dir, args.device)
    print(json.dumps(out, indent=2))
    print(f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} over {out['final_step']} "
          f"steps with {out['failures']} recovered failure(s) in {out['wall_s']:.3f} s on "
          f"{device_label(resolve_device(args.device))}")
    return out


if __name__ == "__main__":
    main()
