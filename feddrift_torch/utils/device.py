"""Where the port's entry points run: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and no card is
    visible, so an entry point never drifts onto the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (or --platform "
            "cpu) to run the port's plain PyTorch path on the CPU")
    return dev
