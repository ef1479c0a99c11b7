"""Serving launcher: continuous batching with optional quantized weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
        --requests 8 --max-new 16 --quant-bits 8 [--device cpu]

Serves the architecture's reduced config on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models.registry import get_arch
from repro_torch.serve.engine import Request, ServeEngine

QUANT_RULES = (r"(wq|wk|wv|wo|w_gate|w_up|w_down|in_proj|out_proj)$",)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--quant-bits", type=int, default=None, choices=[4, 8])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = arch.init_params(gen, arch.reduced_config)
    policy = (
        PrecisionPolicy(rules=((QUANT_RULES[0], args.quant_bits),)) if args.quant_bits else None
    )
    engine = ServeEngine(
        arch, params, max_batch=args.max_batch, max_len=args.max_len, quant=policy, device=device
    )
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            uid=i,
            prompt=rng.integers(0, arch.reduced_config.vocab, rng.integers(2, 8)),
            max_new_tokens=args.max_new,
        )
        for i in range(args.requests)
    ]
    t0 = time.time()
    done = engine.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    print(
        f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
        f"({toks / dt:.1f} tok/s, quant={args.quant_bits or 'none'}, device={device})"
    )
    for r in sorted(done, key=lambda r: r.uid)[:4]:
        print(f"  req{r.uid}: prompt={[int(t) for t in r.prompt]} -> {r.generated}")


if __name__ == "__main__":
    main()
