"""Device selection shared by the port's entry points."""

from __future__ import annotations

import contextlib
import subprocess

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA request when there is no card.

    Entry points default to ``"cuda"``; asking for it without a card raises
    instead of carrying on silently on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 products at full float32 precision inside the block.

    TF32 keeps 10 mantissa bits, so a float path under it would not agree
    with the CPU or the JAX package; training and float evaluation run
    inside this block whatever the caller set, and the caller's setting
    comes back after it.
    """
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def device_label(device: str | torch.device = "cuda") -> str:
    """What a printed time was taken on: a card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (a card below its maximum power runs slower under load), or
    ``"the CPU"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "the CPU"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
