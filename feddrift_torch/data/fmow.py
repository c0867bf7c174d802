"""FMoW-style satellite-image drift dataset: the paper's fifth dataset.

A copy of ``feddrift_tpu/data/fmow.py``: the same seed gives bitwise-equal
``x``, ``y`` and ``concepts``. FMoW's drift is covariate/temporal: the 62
land-use labels keep their meaning while the image distribution shifts
across years and regions. The synthetic path keeps that structure with the
class-prototype sampler of ``data/prototype.py`` (images of
``fmow_image_size`` x ``fmow_image_size`` x 3, 62 classes, prototype seed
4242) plus a per-concept global shift drawn from ``default_rng(4242)``, so
a concept change moves the inputs under fixed labels. The ``-smooth``
family smooths the basis and the shifts over the image grid, keeping each
shift's norm. Then, per (step, client), the sampler's labels and noise and
the ``noise_prob`` flip, in that order, from ``default_rng(seed)``.

Real partitions under ``{data_dir}/fmow/partitions/{change_points}/`` as
``client_{c}_iter_{t}.npz`` files with ``x`` / ``y`` arrays are used
verbatim when every one of them is present (short ones wrap), as the
reference uses them; a partition of another image size raises
``ValueError``. The ``-smooth`` family never reads them.
"""

from __future__ import annotations

import os

import numpy as np

from feddrift_torch.data.changepoints import concept_matrix
from feddrift_torch.data.drift_dataset import DriftDataset
from feddrift_torch.data.prototype import PrototypeSampler, _smooth_rows

NUM_CLASSES = 62  # WILDS FMoW land-use categories


def _try_load_partitions(part_dir: str, num_clients: int, T: int,
                         sample_num: int, image_size: int):
    """``(x, y)`` of real ``client_{c}_iter_{t}.npz`` partitions, or None
    unless all of them are present."""
    if not os.path.isdir(part_dir):
        return None
    x = np.zeros((num_clients, T + 1, sample_num, image_size, image_size, 3),
                 dtype=np.float32)
    y = np.zeros((num_clients, T + 1, sample_num), dtype=np.int32)
    for c in range(num_clients):
        for t in range(T + 1):
            p = os.path.join(part_dir, f"client_{c}_iter_{t}.npz")
            if not os.path.isfile(p):
                return None
            d = np.load(p)
            if d["x"].shape[1:3] != (image_size, image_size):
                raise ValueError(
                    f"{p}: partition images are {d['x'].shape[1:3]}, "
                    f"expected ({image_size}, {image_size}); re-export the "
                    f"partitions or set fmow_image_size accordingly")
            # short partitions wrap, so every slot holds real data
            take = np.arange(sample_num) % len(d["y"])
            x[c, t] = d["x"][take][..., :3]
            y[c, t] = d["y"][take]
    return x, y


def generate_fmow_drift(
    change_points: np.ndarray,
    train_iterations: int,
    num_clients: int,
    sample_num: int,
    noise_prob: float = 0.0,
    time_stretch: int = 1,
    seed: int = 0,
    data_dir: str = "./data",
    image_size: int = 32,
    change_points_name: str = "A",
    smooth_sigma: float = 0.0,
) -> DriftDataset:
    """A full ``[C, T+1, N, image_size, image_size, 3]`` drifting dataset;
    step T is the held-out test step of training step T-1."""
    T = train_iterations
    concepts = concept_matrix(change_points, T + 1, num_clients, time_stretch)
    num_concepts = int(concepts.max()) + 1

    real = None if smooth_sigma > 0 else _try_load_partitions(
        os.path.join(data_dir, "fmow", "partitions", change_points_name),
        num_clients, T, sample_num, image_size)
    if real is not None:
        x, y = real
        if noise_prob > 0:      # label noise applies to real data too
            rng = np.random.default_rng(seed)
            flip = rng.random(y.shape) < noise_prob
            y = np.where(flip, (y + 1) % NUM_CLASSES, y).astype(np.int32)
        return DriftDataset(x=x, y=y, num_classes=NUM_CLASSES,
                            concepts=concepts, name="fmow",
                            meta={"real_data": True})

    proto_rng = np.random.default_rng(4242)
    shape = (image_size, image_size, 3)
    sampler = PrototypeSampler(shape, NUM_CLASSES, proto_seed=4242,
                               smooth_sigma=smooth_sigma)
    concept_shift = proto_rng.normal(0.0, 0.5,
                                     (num_concepts, *shape)).astype(np.float32)
    if smooth_sigma > 0:
        flat = concept_shift.reshape(num_concepts, -1)
        norms = np.linalg.norm(flat, axis=1, keepdims=True)
        flat = _smooth_rows(flat, shape, smooth_sigma)
        # smoothing attenuates the shift: keep its norm
        flat *= norms / np.maximum(np.linalg.norm(flat, axis=1, keepdims=True),
                                   1e-12)
        concept_shift = flat.reshape(num_concepts, *shape).astype(np.float32)

    rng = np.random.default_rng(seed)
    x = np.zeros((num_clients, T + 1, sample_num, *shape), dtype=np.float32)
    y = np.zeros((num_clients, T + 1, sample_num), dtype=np.int32)
    for t in range(T + 1):
        for c in range(num_clients):
            k = int(concepts[t, c]) % num_concepts
            xs, ys = sampler.sample(rng, sample_num)
            xs = xs + concept_shift[k]
            if noise_prob > 0:
                flip = rng.random(sample_num) < noise_prob
                ys = np.where(flip, (ys + 1) % NUM_CLASSES, ys)
            x[c, t], y[c, t] = xs.astype(np.float32), ys
    meta = {"real_data": False}
    if smooth_sigma > 0:
        meta["smooth_sigma"] = smooth_sigma
    return DriftDataset(x=x, y=y, num_classes=NUM_CLASSES, concepts=concepts,
                        name="fmow", meta=meta)
