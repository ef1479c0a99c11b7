"""Device selection shared by the port's entry points."""

from __future__ import annotations

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
