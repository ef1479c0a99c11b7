"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 200 --seq-len 256 --batch 8 --run-dir runs/stablelm [--device cpu]

Trains the architecture's reduced config (``--full-config``: the full one)
on the host mesh, every card of ``--device`` (default ``cuda``) as (n, 1)
over ("data", "model"): one card, or the CPU, trains on that device.
Resume is automatic from ``<run-dir>/ckpt``.  ``--production-mesh`` asks
for JAX's 256 / 512-device mesh and refuses below that, as JAX does.
Every decoder family (dense, MoE, SSM, hybrid, VLM) trains on a mesh of
several devices.  ``TrainLoop`` feeds token batches only, as JAX's does,
so whisper-medium (which trains on audio frames) takes
``launch/steps.py::build_train_step`` instead, on one device or a mesh.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.train.loop import TrainLoop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--run-dir", default="runs/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-config", action="store_true", help="the full-size model")
    ap.add_argument("--production-mesh", choices=["single", "multi"], default=None)
    ap.add_argument("--fail-at", type=int, default=None, help="inject a failure at this step (demo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.production_mesh == "multi")
    else:
        mesh = make_host_mesh(args.device)

    loop = TrainLoop(
        arch_name=args.arch,
        seq_len=args.seq_len,
        global_batch=args.batch,
        mesh=mesh,
        run_dir=args.run_dir,
        reduced=not args.full_config,
        lr=args.lr,
        ckpt_every=args.ckpt_every,
        fail_at_step=args.fail_at,
        device=args.device,
    )
    out = loop.run(args.steps)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
