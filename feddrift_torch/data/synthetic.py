"""Synthetic drifting datasets: SEA, SINE and CIRCLE.

A copy of the numpy path of ``feddrift_tpu/data/synthetic.py`` (:30-124):
the same seed gives bitwise-equal ``x``, ``y`` and ``concepts``. The
reference's threaded C++ generator (its ``native`` backend) is not ported.

- SEA: 3 features uniform on [0, 10]; label f2 + f3 > theta with
  per-concept thresholds {8, 9, 7, 9.5} and 10% base label noise.
- SINE: 2 features uniform on [0, 1]; concept 0: y = 1 iff x2 <= sin(x1),
  concept 1 flips the labels.
- CIRCLE: 2 features uniform on [0, 1]; circles (c=(0.2,0.5), r=0.15) and
  (c=(0.6,0.5), r=0.25); y = 1 outside the circle.

All three also apply the ``noise_prob`` label flip, and take the concept of
each (step, client) from a change-point matrix dilated by ``time_stretch``.
"""

from __future__ import annotations

import numpy as np

from feddrift_torch.data.changepoints import concept_matrix
from feddrift_torch.data.drift_dataset import DriftDataset

SEA_THRESHOLDS = (8.0, 9.0, 7.0, 9.5)
SEA_BASE_NOISE = 0.1


def _sea_sample(rng: np.random.Generator, n: int,
                concept: int) -> tuple[np.ndarray, np.ndarray]:
    x = rng.uniform(0.0, 10.0, size=(n, 3)).astype(np.float32)
    y = (x[:, 1] + x[:, 2] > SEA_THRESHOLDS[concept]).astype(np.int32)
    flip = rng.random(n) < SEA_BASE_NOISE
    y = np.where(flip, 1 - y, y)
    return x, y


def _sine_sample(rng: np.random.Generator, n: int,
                 concept: int) -> tuple[np.ndarray, np.ndarray]:
    x = rng.random((n, 2)).astype(np.float32)
    below = x[:, 1] <= np.sin(x[:, 0])
    y = np.where(below, 1, 0) if concept == 0 else np.where(below, 0, 1)
    return x, y.astype(np.int32)


def _circle_sample(rng: np.random.Generator, n: int,
                   concept: int) -> tuple[np.ndarray, np.ndarray]:
    x = rng.random((n, 2)).astype(np.float32)
    cx, cy, r = (0.2, 0.5, 0.15) if concept == 0 else (0.6, 0.5, 0.25)
    z = (x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2 - r**2
    return x, (z > 0).astype(np.int32)


_SAMPLERS = {
    "sea": (_sea_sample, 3, 2, 4),       # (fn, feature_dim, classes, concepts)
    "sine": (_sine_sample, 2, 2, 2),
    "circle": (_circle_sample, 2, 2, 2),
}


def generate_synthetic(name: str, change_points: np.ndarray,
                       train_iterations: int, num_clients: int,
                       sample_num: int, noise_prob: float = 0.0,
                       time_stretch: int = 1, seed: int = 0) -> DriftDataset:
    """A full ``[C, T+1, N, F]`` drifting dataset; step T is the held-out
    test step of training step T-1."""
    sampler, fdim, n_classes, n_concepts = _SAMPLERS[name]
    if int(change_points.max()) >= n_concepts:
        raise ValueError(
            f"change-point matrix references concept {int(change_points.max())} "
            f"but dataset {name!r} defines only {n_concepts} concepts")
    T = train_iterations
    concepts = concept_matrix(change_points, T + 1, num_clients, time_stretch)
    rng = np.random.default_rng(seed)
    x = np.zeros((num_clients, T + 1, sample_num, fdim), dtype=np.float32)
    y = np.zeros((num_clients, T + 1, sample_num), dtype=np.int32)
    for t in range(T + 1):
        for c in range(num_clients):
            xs, ys = sampler(rng, sample_num, int(concepts[t, c]))
            if noise_prob > 0:
                flip = rng.random(sample_num) < noise_prob
                ys = np.where(flip, 1 - ys, ys)
            x[c, t], y[c, t] = xs, ys
    return DriftDataset(x=x, y=y, num_classes=n_classes, concepts=concepts,
                        name=name)
