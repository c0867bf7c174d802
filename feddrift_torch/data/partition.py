"""Client partitioning of a labelled sample set.

A copy of ``feddrift_tpu/data/partition.py``: the same seed gives the same
index arrays. The reference's CIFAR-10/100 and CINIC-10 loaders share this
logic (fedml_api/data_preprocessing/cifar10/data_loader.py:
``partition_data``): the 'homo' uniform split and the 'hetero'
Dirichlet(alpha) label-skew split with its minimum-size retry loop, and
the per-client label histogram it logs.
"""

from __future__ import annotations

import numpy as np


def partition_homo(n_samples: int, num_clients: int,
                   seed: int = 0) -> list[np.ndarray]:
    """Uniform random split of sample indices across clients."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_samples)
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def partition_hetero(y: np.ndarray, num_clients: int, alpha: float = 0.5,
                     min_size_floor: int = 10,
                     seed: int = 0) -> list[np.ndarray]:
    """Dirichlet(alpha) label-skew partition (data_loader.py 'hetero'):
    for each class, split its indices across clients by Dirichlet
    proportions, balanced so no client exceeds n/num_clients mid-draw;
    resample until every client has at least ``min_size_floor`` samples."""
    rng = np.random.default_rng(seed)
    n = len(y)
    classes = np.unique(y)
    min_size = 0
    while min_size < min_size_floor:
        idx_batch: list[list[int]] = [[] for _ in range(num_clients)]
        for k in classes:
            idx_k = np.where(y == k)[0]
            rng.shuffle(idx_k)
            p = rng.dirichlet(np.repeat(alpha, num_clients))
            # cap clients already at the uniform share (reference's balancing)
            p = np.array([pj * (len(b) < n / num_clients)
                          for pj, b in zip(p, idx_batch)])
            p = p / p.sum()
            cuts = (np.cumsum(p) * len(idx_k)).astype(int)[:-1]
            for b, part in zip(idx_batch, np.split(idx_k, cuts)):
                b.extend(part.tolist())
        min_size = min(len(b) for b in idx_batch)
    return [np.sort(np.asarray(b)) for b in idx_batch]


def partition_counts(y: np.ndarray, parts: list[np.ndarray],
                     num_classes: int) -> np.ndarray:
    """[C, K] label histogram per client — the reference logs this as the
    'data statistics' record (data_loader.py record_net_data_stats)."""
    return np.stack([np.bincount(y[p], minlength=num_classes) for p in parts])
