#!/usr/bin/env python3
"""How far bf16 compute moves the LM's prefill logits, in the JAX package
and in the port, at the reduced configs on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/lm_bf16_drift.py

For each of mamba2-780m, jamba-v0.1-52b and qwen2-vl-2b (reduced, JAX's
init carried to the port, 96 tokens) and whisper-medium (reduced, 64 frames
and 32 decoder tokens through ``whisper_forward``), prints max |difference|
/ max |logit| of: JAX bf16 against JAX f32, the port's bf16 against JAX
f32, and the port's bf16 against JAX bf16; then the share of bf16 values on
which ``jax.nn.silu`` and ``torch.nn.functional.silu`` round differently,
and the same for ``jax.nn.gelu`` and ``F.gelu(approximate="tanh")``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as jt
from repro.models import whisper as jw
from repro.models.registry import get_arch as j_get_arch
from repro_torch.models import transformer as tt
from repro_torch.models import whisper as tw
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import get_arch


def prefill_logits(name: str, compute: str, tokens: np.ndarray):
    jarch, tarch = j_get_arch(name), get_arch(name)
    jcfg = dataclasses.replace(jarch.reduced_config, compute_dtype=getattr(jnp, compute))
    tcfg = dataclasses.replace(tarch.reduced_config, compute_dtype=getattr(torch, compute))
    jparams = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jl, _ = jt.prefill(jcfg, jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, _ = tt.prefill(tcfg, tparams, torch.from_numpy(tokens))
    return np.asarray(jl, np.float32), tl.float().numpy()


def whisper_logits(compute: str, frames: np.ndarray, tokens: np.ndarray):
    jarch, tarch = j_get_arch("whisper-medium"), get_arch("whisper-medium")
    jcfg = dataclasses.replace(jarch.reduced_config, compute_dtype=getattr(jnp, compute))
    tcfg = dataclasses.replace(tarch.reduced_config, compute_dtype=getattr(torch, compute))
    jparams = jarch.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jl = jw.whisper_forward(jcfg, jparams, jnp.asarray(frames), jnp.asarray(tokens))
    with torch.no_grad():
        tl = tw.whisper_forward(tcfg, tparams, torch.from_numpy(frames), torch.from_numpy(tokens))
    return np.asarray(jl, np.float32), tl.float().numpy()


def main() -> None:
    rng = np.random.default_rng(96)
    frames = rng.standard_normal((1, 64, 128)).astype(np.float32)
    dec = rng.integers(0, 512, (1, 32)).astype(np.int32)
    for name in ("mamba2-780m", "jamba-v0.1-52b", "qwen2-vl-2b", "whisper-medium"):
        if name == "whisper-medium":
            j32, _ = whisper_logits("float32", frames, dec)
            j16, t16 = whisper_logits("bfloat16", frames, dec)
        else:
            vocab = get_arch(name).reduced_config.vocab
            tokens = np.random.default_rng(96).integers(0, vocab, (1, 96)).astype(np.int32)
            j32, _ = prefill_logits(name, "float32", tokens)
            j16, t16 = prefill_logits(name, "bfloat16", tokens)
        top = float(np.abs(j32).max())

        def dist(a, b):
            return float(np.abs(a - b).max()) / top

        print(
            f"{name}: JAX bf16 vs f32 {dist(j16, j32):.4f}, port bf16 vs JAX f32 "
            f"{dist(t16, j32):.4f}, port bf16 vs JAX bf16 {dist(t16, j16):.4f} of max |logit|"
        )
    z = np.random.default_rng(0).standard_normal(100_000).astype(np.float32) * 3
    j = np.asarray(jax.nn.silu(jnp.asarray(z).astype(jnp.bfloat16)).astype(jnp.float32))
    t = torch.nn.functional.silu(torch.from_numpy(z).to(torch.bfloat16)).float().numpy()
    print(f"silu in bf16: JAX and torch round differently on {float((j != t).mean()):.4f} of values")
    j = np.asarray(jax.nn.gelu(jnp.asarray(z).astype(jnp.bfloat16)).astype(jnp.float32))
    t = torch.nn.functional.gelu(torch.from_numpy(z).to(torch.bfloat16), approximate="tanh").float().numpy()
    print(f"gelu (tanh) in bf16: JAX and torch round differently on {float((j != t).mean()):.4f} of values")


if __name__ == "__main__":
    main()
