"""Per-cluster aggregation over the ``[M, C, ...]`` client-update stack.

Counterpart of ``feddrift_tpu/resilience/robust_agg.py`` on the main path:
its ``mean`` strategy, the sample-weighted FedAvg (``agg_mean``,
``weighted_mean``, ``_active_counts``, ``_stats``). It is masked: a client
row with weight ``n == 0`` never enters the mean, and a cluster with no
active client keeps its previous parameters. Each call also returns the
``[M, 3]`` stats (active, rejected, clipped) per cluster. Plain PyTorch on
the card for now; a kernel of its own (K2) is queued in ROADMAP. The robust
strategies (median, trimmed mean, Krum, norm clipping) and the reference's
registry that selects among them are not ported (ROADMAP item 12).

Parameters are one tensor with leading ``[M, C]`` (client stack) and
``[M]`` (previous) axes: the packed ``[M, C, P]`` form the round uses.
"""

from __future__ import annotations

import torch


def weighted_mean(client_params, w: torch.Tensor, prev_params):
    """Masked weighted mean over the client axis, the reference's
    operation order: normalise the weights, weight, sum, keep prev where
    the cluster's total weight is 0."""
    denom = w.sum(dim=1)                                   # [M]
    w_norm = w / torch.clamp(denom[:, None], min=1e-12)    # [M, C]
    wb = w_norm.reshape(w_norm.shape + (1,) * (client_params.dim() - 2))
    agg = (client_params * wb).sum(dim=1)
    keep = (denom > 0).reshape((-1,) + (1,) * (prev_params.dim() - 1))
    return torch.where(keep, agg, prev_params)


def _active_counts(n: torch.Tensor):
    """(active mask [M, C] bool, per-cluster active count k [M] int32)."""
    act = n > 0
    return act, act.sum(dim=1).to(torch.int32)


def _stats(k: torch.Tensor) -> torch.Tensor:
    """[M, 3] (active, rejected, clipped): the mean rejects and clips
    nothing."""
    z = torch.zeros_like(k)
    return torch.stack([k, z, z], dim=1).to(torch.float32)


def agg_mean(client_params, n: torch.Tensor, prev_params):
    """``(new_params [M, ...], stats [M, 3])`` of one per-cluster FedAvg of
    ``client_params [M, C, ...]`` weighted by ``n [M, C]``."""
    _, k = _active_counts(n)
    return weighted_mean(client_params, n, prev_params), _stats(k)
