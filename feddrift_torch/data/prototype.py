"""Class-prototype image datasets with label-swap concept drift.

A copy of ``feddrift_tpu/data/prototype.py``: the same files and seed give
bitwise-equal ``x``, ``y``, ``concepts`` and ``meta``. The reference's MNIST
drift pipeline simulates concept drift by label swapping: concept 1 swaps
labels 1<->2, concept 2 swaps 3<->4, concept 3 swaps 5<->6.

Real files under ``data_dir`` are read where they are present, and
``meta["real_data"]`` says so:

- ``MNIST/train/*.json``: LEAF JSON (users / user_data x, y), every user
  pooled;
- ``FederatedEMNIST/emnist_train.h5`` (``pixels`` / ``label``) and
  ``fed_cifar100/cifar100_train.h5`` (``image`` / ``label``): TFF h5, a
  prefix of at most 200,000 samples, uint8 pixels rescaled to [0, 1];
  ``h5py`` is imported only when such a file is present, and a present
  file that the host cannot read raises;
- ``cifar-10-batches-py/data_batch_{1..5}`` and ``cifar-100-python/train``:
  the CIFAR python pickle batches (uint8 CHW rows);
- ``cinic10/train/<class>/*.png``: a torchvision ``ImageFolder`` tree,
  decoded by ``data/png.py``, class ids in sorted directory order; a PNG
  of another shape raises ``ValueError``.

Each reader shuffles its samples once with ``default_rng(100)``; the
(step, client) slices then take consecutive samples, wrapping at the end.
Where no file is present, the images are class-conditional samples of a
low-rank prototype model (``PrototypeSampler``) drawn from numpy
``default_rng``: the basis from ``proto_seed``, then per (step, client) the
labels, the noise and the ``noise_prob`` flip, in that order. The
``-smooth`` family (the basis Gaussian-smoothed over the image grid) is
always synthetic and reads no file, as in the reference.
"""

from __future__ import annotations

import json
import os

import numpy as np

from feddrift_torch.data.changepoints import concept_matrix
from feddrift_torch.data.drift_dataset import DriftDataset, open_h5

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


def _try_load_leaf_mnist(data_dir: str
                         ) -> tuple[np.ndarray, np.ndarray] | None:
    """LEAF MNIST train JSON under ``data_dir/MNIST/train``, every user of
    every ``*.json`` file pooled in sorted file order, or None."""
    train_path = os.path.join(data_dir, "MNIST", "train")
    if not os.path.isdir(train_path):
        return None
    X, Y = [], []
    for f in sorted(os.listdir(train_path)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(train_path, f)) as fh:
            d = json.load(fh)
        for u in d["users"]:
            X.extend(d["user_data"][u]["x"])
            Y.extend(d["user_data"][u]["y"])
    if not X:
        return None
    nX = np.asarray(X, dtype=np.float32)
    nY = np.asarray(Y, dtype=np.int32)
    rng = np.random.default_rng(100)   # the reference's fixed shuffle
    perm = rng.permutation(len(nX))
    return nX[perm], nY[perm]


def _try_load_tff_h5(path: str, x_key: str,
                     feature_shape: tuple[int, ...],
                     max_samples: int = 200_000,
                     ) -> tuple[np.ndarray, np.ndarray] | None:
    """A flat TFF image h5 (datasets ``<x_key>`` and ``label``; the
    FederatedEMNIST and fed_cifar100 layouts), or None where the file or
    either dataset is missing. The per-sample client ``id`` is not used:
    the drift pipeline slices by (client, step) itself. Only a
    ``max_samples`` prefix is read; pixels above 1.5 mark uint8 images,
    rescaled to [0, 1]."""
    if not os.path.isfile(path):
        return None
    with open_h5(path) as f:
        if x_key not in f or "label" not in f:
            return None
        X = np.asarray(f[x_key][:max_samples], np.float32)
        Y = np.asarray(f["label"][:max_samples], np.int32)
    if X.size == 0:
        return None
    if X.max() > 1.5:              # uint8-encoded images -> [0, 1]
        X = X / 255.0
    X = X.reshape(len(X), *feature_shape)
    rng = np.random.default_rng(100)   # LEAF MNIST's shuffle
    perm = rng.permutation(len(X))
    return X[perm], Y[perm]


def _try_load_cifar_batches(data_dir: str, name: str
                            ) -> tuple[np.ndarray, np.ndarray] | None:
    """The CIFAR python pickle batches torchvision downloads:
    ``cifar-10-batches-py/data_batch_{1..5}`` (b"data" ``[N, 3072]`` uint8,
    CHW row-major, and b"labels") or ``cifar-100-python/train``
    (b"fine_labels"), as HWC images in [0, 1]; None without them.
    Unpickling runs code the file names: read only batches you trust."""
    import pickle
    if name == "cifar10":
        d = os.path.join(data_dir, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)]
        label_key = b"labels"
    else:
        d = os.path.join(data_dir, "cifar-100-python")
        files = ["train"]
        label_key = b"fine_labels"
    if not os.path.isdir(d):
        return None
    X, Y = [], []
    for fn in files:
        p = os.path.join(d, fn)
        if not os.path.isfile(p):
            continue
        with open(p, "rb") as fh:
            batch = pickle.load(fh, encoding="bytes")
        X.append(np.asarray(batch[b"data"], np.uint8))
        Y.extend(int(v) for v in batch[label_key])
    if not X:
        return None
    flat = np.concatenate(X).reshape(-1, 3, 32, 32)
    imgs = (flat.transpose(0, 2, 3, 1) / 255.0).astype(np.float32)
    rng = np.random.default_rng(100)   # LEAF MNIST's shuffle
    perm = rng.permutation(len(imgs))
    return imgs[perm], np.asarray(Y, np.int32)[perm]


def _try_load_image_folder(data_dir: str, feature_shape: tuple[int, ...]
                           ) -> tuple[np.ndarray, np.ndarray] | None:
    """A torchvision ``ImageFolder`` PNG tree, ``cinic10/train/<class>/
    *.png``, class ids in sorted class-directory order, images in [0, 1]
    (no per-channel normalisation or augmentation); None without it.
    Other files are skipped; a PNG whose decoded shape is not
    ``feature_shape`` raises ``ValueError``."""
    from feddrift_torch.data.png import decode_png_rgb

    root = os.path.join(data_dir, "cinic10", "train")
    if not os.path.isdir(root):
        return None
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    X, Y = [], []
    for ci, cls in enumerate(classes):
        d = os.path.join(root, cls)
        for fn in sorted(os.listdir(d)):
            if not fn.lower().endswith(".png"):
                continue
            with open(os.path.join(d, fn), "rb") as fh:
                img = decode_png_rgb(fh.read())
            if img.shape != feature_shape:
                raise ValueError(
                    f"{os.path.join(cls, fn)}: decoded shape {img.shape} != "
                    f"dataset spec {feature_shape}")
            X.append(img)
            Y.append(ci)
    if not X:
        return None
    imgs = (np.stack(X) / 255.0).astype(np.float32)
    rng = np.random.default_rng(100)   # LEAF MNIST's shuffle
    perm = rng.permutation(len(imgs))
    return imgs[perm], np.asarray(Y, np.int32)[perm]


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
    is the held-out test step of training step T-1. The real files under
    ``data_dir`` where present (not for ``smooth_sigma > 0``), else the
    prototype sampler."""
    feature_shape, num_classes = SPECS[name]
    rng = np.random.default_rng(seed)
    T = train_iterations

    real: tuple[np.ndarray, np.ndarray] | None = None
    if smooth_sigma > 0:
        pass    # the -smooth family is always synthetic
    elif name == "MNIST":
        real = _try_load_leaf_mnist(data_dir)
    elif name == "femnist":
        real = _try_load_tff_h5(
            os.path.join(data_dir, "FederatedEMNIST", "emnist_train.h5"),
            "pixels", feature_shape)
    elif name == "fed_cifar100":
        real = _try_load_tff_h5(
            os.path.join(data_dir, "fed_cifar100", "cifar100_train.h5"),
            "image", feature_shape)
    elif name in ("cifar10", "cifar100"):
        real = _try_load_cifar_batches(data_dir, name)
    elif name == "cinic10":
        real = _try_load_image_folder(data_dir, feature_shape)
    sampler = PrototypeSampler(feature_shape, num_classes,
                               smooth_sigma=smooth_sigma)
    used = 0

    x = np.zeros((num_clients, T + 1, sample_num, *feature_shape),
                 dtype=np.float32)
    y = np.zeros((num_clients, T + 1, sample_num), dtype=np.int32)
    concepts = concept_matrix(change_points, T + 1, num_clients, time_stretch)
    for t in range(T + 1):
        for c in range(num_clients):
            if real is not None:
                rx, ry = real
                if used + sample_num > len(rx):  # wrap when exhausted
                    used = 0
                take = np.arange(used, used + sample_num) % len(rx)
                xs = rx[take].reshape(sample_num, *feature_shape)
                ys = ry[take].copy()
                used = (used + sample_num) % len(rx)
            else:
                xs, ys = sampler.sample(rng, sample_num)
            ys = apply_label_swap(ys, int(concepts[t, c]), num_classes)
            if noise_prob > 0:
                flip = rng.random(sample_num) < noise_prob
                ys = np.where(flip, (ys + 1) % num_classes, ys)
            x[c, t], y[c, t] = xs, ys
    meta = {"real_data": real is not None}
    if smooth_sigma > 0:
        meta["smooth_sigma"] = smooth_sigma
    return DriftDataset(x=x, y=y, num_classes=num_classes, concepts=concepts,
                        name=name, meta=meta)
