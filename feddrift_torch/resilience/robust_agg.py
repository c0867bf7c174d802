"""Per-cluster aggregation over the ``[M, C, ...]`` client-update stack.

Counterpart of ``feddrift_tpu/resilience/robust_agg.py`` on the main path:
its ``mean`` strategy, the sample-weighted FedAvg (``agg_mean``). It is
masked: a client row with weight ``n == 0`` never enters the mean, and a
cluster with no active client keeps its previous parameters. Each call also
returns the ``[M, 3]`` stats (active, rejected, clipped) per cluster.
``agg_mean`` runs K2 (``kernels/fedavg.py``: the CUDA kernel on the card,
its plain version on the CPU); the plain pieces ``weighted_mean``,
``_active_counts`` and ``_stats`` live beside the kernel and are the
reference's functions of those names. The robust strategies (median,
trimmed mean, Krum, norm clipping) and the reference's registry that
selects among them are not ported (ROADMAP §1 'In-round robustness,
population and streaming').

Parameters are the packed ``[M, C, P]`` client stack and ``[M, P]``
previous params the round uses.
"""

from __future__ import annotations

import torch

from feddrift_torch.kernels.fedavg import (  # noqa: F401  (the plain pieces)
    _active_counts, _stats, fedavg, weighted_mean)


def agg_mean(client_params, n: torch.Tensor, prev_params, *,
             stats_out: torch.Tensor | None = None):
    """``(new_params [M, P], stats [M, 3])`` of one per-cluster FedAvg of
    ``client_params [M, C, P]`` weighted by ``n [M, C]``; ``stats_out``:
    as ``kernels.fedavg.fedavg``."""
    return fedavg(client_params, n, prev_params, stats_out=stats_out)
