"""Numerical primitives: loss, confusion matrices and selection over
parameter dicts.

Counterparts of ``feddrift_tpu/core/functional.py::cross_entropy``,
``confusion_matrix`` and ``tree_select``.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over every leading axis (the reference's
    ``nn.CrossEntropyLoss``)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long().unsqueeze(-1)).mean()


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """``[..., K, K]`` float32 counts over the sample axis (the last axis of
    ``labels``): rows the true label, columns the argmax prediction (KUE's
    kappa)."""
    K = num_classes
    flat = labels.long() * K + logits.argmax(-1)
    counts = torch.zeros((*flat.shape[:-1], K * K), dtype=torch.float32,
                         device=logits.device)
    counts.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.float32))
    return counts.unflatten(-1, (K, K))


def tree_select(cond: torch.Tensor | bool, a: dict, b: dict) -> dict:
    """Leaf-wise ``where(cond, a, b)`` over two dicts of tensors; ``cond``
    is a scalar (a Python bool or a 0-d tensor)."""
    return {k: torch.where(torch.as_tensor(cond, device=a[k].device), a[k],
                           b[k]) for k in a}
