"""Dataset registry of the port: ``make_dataset(cfg)``.

Mirrors ``feddrift_tpu/data/registry.py``. Ported so far: the synthetic
tabular datasets of the training slice (``sea``, ``sine``, ``circle``, their
numpy path), the synthetic prototype image data (``MNIST``, ``femnist``,
``cifar10``, ``cifar100``, ``cinic10`` and ``fed_cifar100``, each with its
``-smooth`` name), FMoW (``fmow`` and ``fmow-smooth``: 62 classes of
``fmow_image_size`` x ``fmow_image_size`` x 3 images, real ``.npz``
partitions read where they are present), the UCI streams ``susy`` and
``ro`` (synthetic, or their CSV where it is present), ``stackoverflow_lr``
(synthetic bag-of-words) and the character datasets of the transformer
serving slice (``shakespeare`` and its alias ``fed_shakespeare``); any
other name (``stackoverflow`` and ``stackoverflow_nwp`` among them) raises
``KeyError``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.data import changepoints as cp
from feddrift_torch.data.drift_dataset import DriftDataset
from feddrift_torch.data.fmow import generate_fmow_drift
from feddrift_torch.data.prototype import generate_prototype_drift
from feddrift_torch.data.synthetic import generate_synthetic
from feddrift_torch.data.tabular import (generate_stackoverflow_lr_drift,
                                         generate_uci_drift)
from feddrift_torch.data.text import generate_text_drift

_REGISTRY: dict[str, Callable[..., DriftDataset]] = {}


def register_dataset(*names: str):
    """Register a builder ``(cfg, change_points) -> DriftDataset`` under names."""
    def deco(fn: Callable[[ExperimentConfig, np.ndarray], DriftDataset]):
        for n in names:
            _REGISTRY[n] = fn
        return fn
    return deco


def available_datasets() -> list[str]:
    return sorted(_REGISTRY)


def _resolve_change_points(cfg: ExperimentConfig) -> np.ndarray:
    if cfg.change_points == "rand":
        return cp.generate_random_change_points(
            cfg.train_iterations, cfg.client_num_in_total, cfg.drift_together,
            cfg.time_stretch, seed=cfg.seed)
    return cp.load_change_points(cfg.change_points)


for _name in ("sea", "sine", "circle"):
    @register_dataset(_name)
    def _mk(cfg: ExperimentConfig, change_points: np.ndarray, *,
            _n=_name) -> DriftDataset:
        return generate_synthetic(
            _n, change_points, cfg.train_iterations, cfg.client_num_in_total,
            cfg.sample_num, cfg.noise_prob, cfg.time_stretch, cfg.seed)


# "<name>": real files under data_dir are refused (not ported), else the
# white-noise-basis prototypes; "<name>-smooth": the Gaussian-smoothed basis,
# always synthetic (the reference ignores real files there)
for _name in ("MNIST", "femnist", "cifar10", "cifar100", "cinic10",
              "fed_cifar100"):
    for _suffix, _smooth in (("", False), ("-smooth", True)):
        @register_dataset(_name + _suffix)
        def _mk_img(cfg: ExperimentConfig, change_points: np.ndarray,
                    *, _n=_name, _sm=_smooth) -> DriftDataset:
            return generate_prototype_drift(
                _n, change_points, cfg.train_iterations,
                cfg.client_num_in_total, cfg.sample_num, cfg.noise_prob,
                cfg.time_stretch, cfg.seed, cfg.data_dir,
                smooth_sigma=cfg.smooth_sigma if _sm else 0.0)


for _suffix, _smooth in (("", False), ("-smooth", True)):
    @register_dataset("fmow" + _suffix)
    def _mk_fmow(cfg: ExperimentConfig, change_points: np.ndarray,
                 *, _sm=_smooth) -> DriftDataset:
        return generate_fmow_drift(
            change_points, cfg.train_iterations, cfg.client_num_in_total,
            cfg.sample_num, cfg.noise_prob, cfg.time_stretch, cfg.seed,
            cfg.data_dir, cfg.fmow_image_size, cfg.change_points,
            smooth_sigma=cfg.smooth_sigma if _sm else 0.0)


@register_dataset("shakespeare", "fed_shakespeare")
def _mk_text(cfg: ExperimentConfig, change_points: np.ndarray) -> DriftDataset:
    return generate_text_drift(
        change_points, cfg.train_iterations, cfg.client_num_in_total,
        cfg.sample_num, cfg.noise_prob, cfg.time_stretch, cfg.seed,
        seq_len=cfg.text_seq_len, data_dir=cfg.data_dir)


@register_dataset("susy", "ro")
def _mk_uci(cfg: ExperimentConfig, change_points: np.ndarray) -> DriftDataset:
    return generate_uci_drift(
        cfg.dataset, change_points, cfg.train_iterations,
        cfg.client_num_in_total, cfg.sample_num, cfg.noise_prob,
        cfg.time_stretch, cfg.seed, cfg.data_dir)


@register_dataset("stackoverflow_lr")
def _mk_so_lr(cfg: ExperimentConfig, change_points: np.ndarray) -> DriftDataset:
    return generate_stackoverflow_lr_drift(
        change_points, cfg.train_iterations, cfg.client_num_in_total,
        cfg.sample_num, cfg.noise_prob, cfg.time_stretch, cfg.seed,
        vocab_size=cfg.so_vocab_size, tag_size=cfg.so_tag_size,
        data_dir=cfg.data_dir)


def make_dataset(cfg: ExperimentConfig) -> DriftDataset:
    if cfg.dataset not in _REGISTRY:
        raise KeyError(f"unknown dataset {cfg.dataset!r}; available: "
                       f"{available_datasets()}")
    change_points = _resolve_change_points(cfg)
    if change_points.shape[1] < cfg.client_num_in_total:
        raise ValueError(
            f"change-point matrix has {change_points.shape[1]} clients < "
            f"client_num_in_total={cfg.client_num_in_total}")
    return _REGISTRY[cfg.dataset](cfg, change_points)
