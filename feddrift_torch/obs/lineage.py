"""Oracle agreement scores of a clustering against ground-truth concepts.

Copies of ``feddrift_tpu/obs/lineage.py::adjusted_rand_index`` and
``cluster_purity``, which ``DriftAlgorithm.emit_assignment`` puts on every
``cluster_assign`` event. The genealogy reconstruction and its CLI are
not ported.
"""

from __future__ import annotations

import numpy as np


def adjusted_rand_index(labels_true, labels_pred) -> float:
    """Adjusted Rand Index between two labelings (permutation-invariant),
    Hubert-Arabie form via the contingency table. Two trivial
    single-cluster partitions agree perfectly (1.0) rather than 0/0."""
    a = np.asarray(labels_true).ravel()
    b = np.asarray(labels_pred).ravel()
    if a.size != b.size:
        raise ValueError(f"label length mismatch: {a.size} vs {b.size}")
    n = a.size
    if n == 0:
        return 0.0
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    cont = np.zeros((int(ai.max()) + 1, int(bi.max()) + 1), dtype=np.int64)
    np.add.at(cont, (ai, bi), 1)

    def comb2(x):
        x = np.asarray(x, dtype=np.float64)
        return x * (x - 1) / 2.0

    sum_ij = comb2(cont).sum()
    sum_a = comb2(cont.sum(axis=1)).sum()
    sum_b = comb2(cont.sum(axis=0)).sum()
    total = comb2(n)
    expected = sum_a * sum_b / total if total else 0.0
    max_index = (sum_a + sum_b) / 2.0
    if max_index == expected:        # both partitions trivial -> identical
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))


def cluster_purity(labels_true, labels_pred) -> float:
    """Fraction of points whose predicted cluster's majority true label
    matches their own."""
    a = np.asarray(labels_true).ravel()
    b = np.asarray(labels_pred).ravel()
    if a.size != b.size:
        raise ValueError(f"label length mismatch: {a.size} vs {b.size}")
    if a.size == 0:
        return 0.0
    correct = 0
    for cl in np.unique(b):
        _, counts = np.unique(a[b == cl], return_counts=True)
        correct += int(counts.max())
    return float(correct / a.size)
