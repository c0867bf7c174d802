"""Class-prototype image datasets with label-swap concept drift.

A copy of the synthetic path of ``feddrift_tpu/data/prototype.py``
(:42-146, :286-354): the same seed gives bitwise-equal ``x``, ``y`` and
``concepts``. The reference's MNIST drift pipeline simulates concept drift
by label swapping: concept 1 swaps labels 1<->2, concept 2 swaps 3<->4,
concept 3 swaps 5<->6. Its images are class-conditional samples of a
low-rank prototype model (``PrototypeSampler``) drawn from numpy
``default_rng``: the basis from ``proto_seed``, then per (step, client) the
labels, the noise and the ``noise_prob`` flip, in that order.

Ported: ``MNIST`` (784, 10 classes), ``femnist`` (784, 62), ``cifar10``
and ``cinic10`` (32x32x3, 10), ``cifar100`` and ``fed_cifar100`` (32x32x3,
100), each with its ``-smooth`` family (the basis Gaussian-smoothed over the
image grid, always synthetic, as in the reference). The reference reads
real files under ``data_dir`` where they exist (``_REAL_FILES``: LEAF JSON
for MNIST, TFF h5 for femnist and fed_cifar100, the CIFAR python pickle
batches, cinic10's PNG folder); those readers are not ported, so the port
refuses such files with ``NotImplementedError`` (ROADMAP §1 "The other
datasets") rather than make synthetic data in their place.
"""

from __future__ import annotations

import os

import numpy as np

from feddrift_torch.data.changepoints import concept_matrix
from feddrift_torch.data.drift_dataset import DriftDataset

# Reference label swaps per concept id (data_loader_cont.py:188-201).
_LABEL_SWAPS = {1: (1, 2), 2: (3, 4), 3: (5, 6)}

SPECS = {
    # name: (feature_shape, num_classes)
    "MNIST": ((784,), 10),
    "femnist": ((784,), 62),
    "cifar10": ((32, 32, 3), 10),
    "cifar100": ((32, 32, 3), 100),
    "cinic10": ((32, 32, 3), 10),
    "fed_cifar100": ((32, 32, 3), 100),
}

# the real files the reference reads under data_dir, by dataset: (path
# parts, a directory or not); fed_cifar100 is cifar100 with the TFF
# per-client partition, so the two share the sampler
_REAL_FILES = {
    "MNIST": (("MNIST", "train"), True),
    "femnist": (("FederatedEMNIST", "emnist_train.h5"), False),
    "fed_cifar100": (("fed_cifar100", "cifar100_train.h5"), False),
    "cifar10": (("cifar-10-batches-py",), True),
    "cifar100": (("cifar-100-python",), True),
    "cinic10": (("cinic10", "train"), True),
}


def apply_label_swap(y: np.ndarray, concept: int,
                     num_classes: int) -> np.ndarray:
    """Swap the concept's label pair; identity for concept 0."""
    if concept == 0:
        return y
    a, b = _LABEL_SWAPS.get(concept, ((2 * concept - 1) % num_classes,
                                      (2 * concept) % num_classes))
    out = y.copy()
    out[y == a] = b
    out[y == b] = a
    return out


def _spatial_dims(feature_shape: tuple[int, ...]) -> tuple[int, int] | None:
    """(H, W) of the image grid, or None when the shape has no 2D layout
    (a flat square shape such as MNIST's (784,) is a 28x28 image)."""
    if len(feature_shape) >= 2:
        return feature_shape[0], feature_shape[1]
    side = int(round(feature_shape[0] ** 0.5))
    return (side, side) if side * side == feature_shape[0] else None


def _smooth_rows(rows: np.ndarray, feature_shape: tuple[int, ...],
                 sigma: float) -> np.ndarray:
    """Gaussian-smooth each row over the image grid (channels untouched)."""
    hw = _spatial_dims(feature_shape)
    if hw is None or sigma <= 0:
        return rows
    from scipy.ndimage import gaussian_filter
    h, w = hw
    rest = int(np.prod(feature_shape)) // (h * w)   # channels (1 for flat)
    shaped = rows.reshape(-1, h, w, rest)
    # sigma 0 on the row and channel axes: smooth the image grid only
    out = gaussian_filter(shaped, sigma=(0, sigma, sigma, 0), mode="wrap")
    return out.reshape(rows.shape)


class PrototypeSampler:
    """Class-conditional sampler: classes live in a shared ``rank``-dim
    subspace, separated by coefficient offsets of scale ``sep`` against
    sample noise of scale ``noise_scale``. ``smooth_sigma > 0`` smooths
    each basis field over the image grid before normalisation."""

    def __init__(self, feature_shape: tuple[int, ...], num_classes: int,
                 noise_scale: float = 0.8, sep: float = 0.7, rank: int = 16,
                 proto_seed: int = 1234, smooth_sigma: float = 0.0) -> None:
        self.feature_shape = feature_shape
        self.num_classes = num_classes
        self.noise_scale = noise_scale
        self.smooth_sigma = smooth_sigma
        proto_rng = np.random.default_rng(proto_seed)
        dim = int(np.prod(feature_shape))
        basis = proto_rng.normal(size=(rank, dim))
        basis = _smooth_rows(basis, feature_shape, smooth_sigma)
        basis /= np.linalg.norm(basis, axis=1, keepdims=True)
        coef = proto_rng.normal(size=(num_classes, rank)) * sep
        self.prototypes = (0.5 + coef @ basis).reshape(
            num_classes, *feature_shape).astype(np.float32)

    def sample(self, rng: np.random.Generator,
               n: int) -> tuple[np.ndarray, np.ndarray]:
        # the noise is drawn in float64 and cast per batch, as the reference
        y = rng.integers(0, self.num_classes, size=n).astype(np.int32)
        x = self.prototypes[y] + rng.normal(
            0.0, self.noise_scale,
            size=(n, *self.feature_shape)).astype(np.float32)
        return x.astype(np.float32), y


def generate_prototype_drift(
    name: str,
    change_points: np.ndarray,
    train_iterations: int,
    num_clients: int,
    sample_num: int,
    noise_prob: float = 0.0,
    time_stretch: int = 1,
    seed: int = 0,
    data_dir: str = "./data",
    smooth_sigma: float = 0.0,
) -> DriftDataset:
    """A full ``[C, T+1, N, *feature_shape]`` drifting image dataset; step T
    is the held-out test step of training step T-1."""
    feature_shape, num_classes = SPECS[name]
    # the -smooth family is always the synthetic sampler, as the reference's
    parts, is_dir = _REAL_FILES[name]
    real = os.path.join(data_dir, *parts)
    if smooth_sigma <= 0 and (os.path.isdir(real) if is_dir
                              else os.path.isfile(real)):
        raise NotImplementedError(
            f"real {name} files ({real}) are not ported yet (ROADMAP §1 'The "
            f"other datasets'); point data_dir elsewhere for the synthetic "
            f"prototype data")
    rng = np.random.default_rng(seed)
    T = train_iterations
    sampler = PrototypeSampler(feature_shape, num_classes,
                               smooth_sigma=smooth_sigma)
    x = np.zeros((num_clients, T + 1, sample_num, *feature_shape),
                 dtype=np.float32)
    y = np.zeros((num_clients, T + 1, sample_num), dtype=np.int32)
    concepts = concept_matrix(change_points, T + 1, num_clients, time_stretch)
    for t in range(T + 1):
        for c in range(num_clients):
            xs, ys = sampler.sample(rng, sample_num)
            ys = apply_label_swap(ys, int(concepts[t, c]), num_classes)
            if noise_prob > 0:
                flip = rng.random(sample_num) < noise_prob
                ys = np.where(flip, (ys + 1) % num_classes, ys)
            x[c, t], y[c, t] = xs, ys
    meta = {"real_data": False}
    if smooth_sigma > 0:
        meta["smooth_sigma"] = smooth_sigma
    return DriftDataset(x=x, y=y, num_classes=num_classes, concepts=concepts,
                        name=name, meta=meta)
