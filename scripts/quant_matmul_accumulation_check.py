#!/usr/bin/env python3
"""How exactly the ``quant_matmul`` kernel accumulates at large K, beside
cuBLAS's own bf16 GEMM and its f32 FFMA GEMM, and the wide route's time.

    python3 scripts/quant_matmul_accumulation_check.py   # one card

For [4096, K] x [K, N] int8 products (random bf16 activations, weights from
N(0, 1/K) quantized per column) at K = 2048 ... 14336, prints the max error
against the f64 product, as a share of max |y|, of: the wide route with an
f32 output (its tensor-core chain promoted into f32 sums every 512 K);
cuBLAS's bf16 GEMM of the same operands with an f32 output (the tensor
cores, as the kernel uses them); cuBLAS's f32 GEMM with TF32 off
(``quant_matmul_ref``, FFMA); then how much of phase 2's bf16 tolerance
(``chip_smoke.QM_TOL``) the kernel's bf16 output uses against the plain
version.  The same for the skinny (split-K ``mma.sync``) route at M = 8.
Then the wide route's device time at [4096,2048]x[2048,5632] and
[4096,14336]x[14336,4096], beside its plain version's (``quant_matmul_ref``)
and the library's (``torch.matmul`` in bf16 of the dequantized weight, made
beforehand).  Each line names the card and its power limit.
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

SHAPES = [(2048, 2048), (4096, 4096), (8192, 4096), (14336, 4096)]
TIMED = [(4096, 2048, 5632), (4096, 14336, 4096)]


def errors(M: int, K: int, N: int, gen, smi: str, route: str) -> None:
    w = torch.randn(K, N, device="cuda", generator=gen) * K**-0.5
    x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
    qt = cs.quantize_weight(w, 8)
    exact = (x.double() @ qt.q.double()) * qt.scale.double()
    top = float(exact.abs().max())

    def err(y):
        return float((y.double() - exact).abs().max()) / top

    kernel = cs.quant_matmul(x, qt.q, qt.scale, bits=8, out_dtype=torch.float32)
    library = torch.mm(x, qt.q.to(torch.bfloat16), out_dtype=torch.float32) * qt.scale
    ffma = (x.float() @ qt.q.float()) * qt.scale
    got = cs.quant_matmul(x, qt.q, qt.scale, bits=8)
    want = cs.quant_matmul_ref(x, qt.q, qt.scale, 8, torch.bfloat16)
    print(
        f"[{M},{K}]x[{K},{N}] int8, {route} route: error / max |y| against f64: kernel "
        f"{err(kernel):.3e}, cuBLAS bf16 GEMM (f32 out) {err(library):.3e}, cuBLAS f32 FFMA "
        f"{err(ffma):.3e}; share of QM_TOL used by the kernel's bf16 output "
        f"{cs.tol_used(got, want, cs.QM_TOL):.3f}; on {smi}",
        flush=True,
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cs.build.load_all()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for K, N in SHAPES:
        errors(4096, K, N, gen, smi, "wide")
    for K, N in SHAPES:
        errors(8, K, N, gen, smi, "skinny")
    for M, K, N in TIMED:
        x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
        qt = cs.quantize_weight(torch.randn(K, N, device="cuda", generator=gen) * K**-0.5, 8)
        wd = cs.dequantize_weight(qt, torch.bfloat16)
        ms = cs.time_ms(lambda: cs.quant_matmul(x, qt.q, qt.scale, bits=8), reps=7, inner=3)
        plain_ms = cs.time_ms(lambda: cs.quant_matmul_ref(x, qt.q, qt.scale, 8, torch.bfloat16),
                              reps=3, inner=2)
        library_ms = cs.time_ms(lambda: torch.matmul(x, wd), reps=7, inner=3)
        print(
            f"wide route [{M},{K}]x[{K},{N}] int8: {ms:.5f} device ms, "
            f"{2 * M * K * N / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.5f} ms, library "
            f"{library_ms:.5f} ms (torch.matmul, bf16); on {smi}",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
