"""Device resolution for the port's entry points: they run on the card
unless the caller asks for another device, and never fall back."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (None = "cuda") as a torch.device; raises when CUDA is
    asked for (or defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on the "
            "card by default; pass device='cpu' to run on the CPU")
    return dev
