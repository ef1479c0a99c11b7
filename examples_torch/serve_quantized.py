"""Batched LM serving on the port with Flex-plorer-chosen weight precision.

    PYTHONPATH=src python examples_torch/serve_quantized.py               # on the card
    PYTHONPATH=src python examples_torch/serve_quantized.py --device cpu

Serves a reduced gemma2-family model with continuous batching, twice: at
full precision and with the paper's technique applied (int8 attention +
int4 MLP weights through the ``quant_matmul`` kernel).  Prints the outputs
side by side and the modeled decode-step memory traffic of the full-size
config -- the number the decode_32k roofline cells are bound by -- over the
HBM bandwidth of the card the port targets, the NVIDIA H100 SXM
(``distributed.hlo_analysis.HW.hbm_bw``, 3.35 TB/s).  The weights come from
``torch.Generator(device).manual_seed(0)``, not from ``jax.random``, so the
generated tokens differ from the JAX example's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import device_label, resolve_device
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.distributed.hlo_analysis import HW
from repro_torch.distributed.structural import structural_bytes
from repro_torch.models.registry import SHAPES, get_arch
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "gemma2-27b"
PROMPTS = [np.asarray([11, 42, 7]), np.asarray([99, 3]), np.asarray([5, 5, 5, 5])]
POLICIES = [
    ("bf16", None),
    ("int8-attn/int4-mlp", PrecisionPolicy(rules=(
        (r"(wq|wk|wv|wo)$", 8), (r"(w_gate|w_up|w_down)$", 4),
    ))),
]
HBM_CARD = "NVIDIA H100 SXM"  # whose data-sheet rate HW.hbm_bw is


def serve(device: str | torch.device = "cuda") -> dict:
    """Both passes of the reduced config: ``{label: (uid -> tokens, wall s)}``."""
    dev = resolve_device(device)
    arch = get_arch(ARCH)
    params = arch.init_params(torch.Generator(device=dev).manual_seed(0), arch.reduced_config)
    out = {}
    for label, policy in POLICIES:
        eng = ServeEngine(arch, params, max_batch=2, max_len=64, quant=policy, device=dev)
        t0 = time.perf_counter()
        done = eng.run([Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(PROMPTS)])
        out[label] = ({r.uid: r.generated for r in done}, time.perf_counter() - t0)
    return out


def decode_traffic() -> dict:
    """Full-size gemma2-27b decode_32k bytes a device a step at 16 / 8 / 4
    bits, and the step time each gives at the card's HBM roofline."""
    arch, shape = get_arch(ARCH), SHAPES["decode_32k"]
    out = {}
    for label, bits in (("bf16/f32", None), ("int8", 8), ("int4", 4)):
        total = structural_bytes(arch, shape, quant_bits=bits)["total"]
        out[label] = {"bytes": total, "us_per_step": total / HW.hbm_bw * 1e6}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = serve(args.device)
    label_dev = device_label(resolve_device(args.device))
    for label, (tokens, wall) in results.items():
        print(f"[{label:>18}] served {len(tokens)} requests in {wall:.3f} s on {label_dev}")
        for uid in sorted(tokens):
            print(f"    req{uid}: {tokens[uid]}")
    (full, _), (quant, _) = results["bf16"], results["int8-attn/int4-mlp"]
    agree = sum(full[u] == quant[u] for u in full)
    print(
        f"\ngreedy outputs identical under int8/int4: {agree}/{len(PROMPTS)} "
        "(random-init weights give near-uniform logits, so argmax is "
        "quantization-sensitive here; the int8-KV path is greedy-preserving in "
        "tests/test_torch_precision_paths.py)"
    )
    traffic = decode_traffic()
    print(f"\nfull-size {ARCH} decode_32k memory traffic per device per step, at the "
          f"{HBM_CARD}'s HBM roofline ({HW.hbm_bw / 1e12:.2f} TB/s; a model, not a measurement):")
    for label, t in traffic.items():
        print(f"  {label + ' weights:':<18} {t['bytes'] / 1e9:.2f} GB  -> "
              f"{t['us_per_step']:.0f} us/step")
    return {"results": results, "traffic": traffic, "agree": agree}


if __name__ == "__main__":
    main()
