"""Checks that the kernel wrappers share before a launch on the card."""

from __future__ import annotations

import torch


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record a call on ``tensors``. A kernel with
    no backward refuses such a call on the card rather than return a
    result that silently carries no gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
