"""Drift-adaptation algorithm interface (dense mode).

Counterpart of ``feddrift_tpu/algorithms/base.py``. An algorithm owns the
host-side state machine and steers the device through four hooks:

- ``begin_iteration(t)``: start-of-time-step clustering / drift detection.
  May edit the model pool.
- ``round_inputs(t, r)``: the ``[M, C, T1]`` time-weight tensor, the
  per-sample weights ``[M, C, N]`` and feature masks ``[M, *features]``
  (None: ones) and the LR scale, consumed by ``TrainStep``.
- ``after_round(...)``: post-aggregation work; returns the params the pool
  adopts. On the per-round path it runs after every round; on the fused
  path (``chunkable``) once, after the last.
- ``end_iteration(t)``: state updates at the end of a time step.

Only dense mode is ported: every client is on the device axis, and no
client's accuracies are excluded as stale (the reference's behaviour with
``acc_staleness_limit`` 0, its default). Population cohorts are not
ported. An ensemble algorithm (AUE, KUE) names its test-time vote with
``ensemble_spec``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from feddrift_torch import obs

_REGISTRY: dict[str, Callable[..., "DriftAlgorithm"]] = {}


def register_algorithm(*names: str):
    def deco(cls):
        for n in names:
            _REGISTRY[n] = cls
        return cls
    return deco


def available_algorithms() -> list[str]:
    return sorted(_REGISTRY)


def algorithm_class(name: str) -> type:
    if name not in _REGISTRY:
        raise KeyError(f"unknown concept_drift_algo {name!r}; "
                       f"available: {available_algorithms()}")
    return _REGISTRY[name]


def make_algorithm(cfg, ds, pool, step) -> "DriftAlgorithm":
    return algorithm_class(cfg.concept_drift_algo)(cfg, ds, pool, step)


@dataclass
class EnsembleSpec:
    """Ensemble-vote evaluation (AUE's hard vote, KUE's soft vote)."""
    mode: str                                   # 'hard' | 'soft'
    weights: np.ndarray                         # [M] or [M, C]
    model_mask: Optional[np.ndarray] = None     # [M], 1 = votes


class DriftAlgorithm:
    name = "base"
    # True for an algorithm whose after_round reads the [M, C, ...] client
    # params of the round (CFL, legacy ClusterFL); the others get None there
    needs_client_params = False
    # Class trait: True if round_inputs returns per-sample weights (KUE's
    # Poisson bootstrap). The runner reads it before the algorithm exists
    # and builds its TrainStep with the weighted draw (K4); sample weights
    # from an algorithm without it would be ignored.
    uses_sample_weights = False

    def __init__(self, cfg, ds, pool, step) -> None:
        self.cfg = cfg
        self.ds = ds
        self.pool = pool
        self.step = step
        self.M = pool.num_models
        self.C = cfg.device_clients
        self.T1 = ds.num_steps + 1
        self.N = ds.samples_per_step
        self.x = self.y = self.logger = None
        self._acc_offer = None

    # -- runtime binding ------------------------------------------------
    def bind(self, x, y, logger) -> None:
        """The device-resident dataset and the metrics logger, after
        construction."""
        self.x = x
        self.y = y
        self.logger = logger
        self._acc_offer = None

    def offer_acc_matrix(self, params, offers: "dict[int, np.ndarray]") -> None:
        """Cache accuracies the fused iteration already computed: the final
        eval slot holds acc(final params) on step t and t+1 data, which
        ``acc_matrix_at`` would otherwise recompute on the device. Keyed on
        the identity of the EVALUATED params dict; any pool edit rebinds
        ``pool.params`` and so invalidates it. Offered matrices are frozen,
        since a hit hands the same array to every consumer."""
        frozen = {}
        for t, arr in offers.items():
            arr = np.asarray(arr)
            arr.setflags(write=False)
            frozen[t] = arr
        self._acc_offer = (params, frozen)

    def acc_matrix_at(self, t: int) -> np.ndarray:
        """[M, C] accuracy of every model on every client's step-t data."""
        offer = self._acc_offer
        if offer is not None and offer[0] is self.pool.params \
                and t in offer[1]:
            return offer[1][t]
        correct, _, total = self.step.acc_matrix(
            self.pool.params, self.x[:, t], self.y[:, t])
        correct, total = correct.cpu().numpy(), total.cpu().numpy()
        return correct[:, :self.C] / total[None, :self.C]

    def acc_cells_upto(self, t: int) -> np.ndarray:
        """[M, C, t+1] correct counts per (model, client, step <= t); the
        full [T1] axis is evaluated and sliced on the host."""
        correct = self.step.acc_cells(self.pool.params, self.x, self.y)
        return correct.cpu().numpy()[:, :self.C, : t + 1]

    # -- hooks ----------------------------------------------------------
    def begin_iteration(self, t: int) -> None:
        raise NotImplementedError

    def round_inputs(self, t: int, r: int):
        """-> (time_w [M, C, T1] tensor, sample_w, feat_mask, lr_scale)."""
        raise NotImplementedError

    def after_round(self, t: int, r: int, prev_params, agg_params,
                    client_params, n) -> Any:
        """The params the pool adopts for the next round."""
        return agg_params

    def chunkable(self, t: int) -> bool:
        """True if the rounds of step t may run as one fused loop
        (round-invariant inputs, no per-round host work)."""
        return False

    def end_iteration(self, t: int) -> None:
        pass

    # -- evaluation routing --------------------------------------------
    def test_model_idx(self, t: int) -> np.ndarray:
        """[C] model index per client for test-data eval."""
        return np.zeros((self.C,), dtype=np.int64)

    def train_model_idx(self, t: int) -> np.ndarray:
        return self.test_model_idx(t)

    def ensemble_spec(self, t: int):
        return None

    # -- checkpointing --------------------------------------------------
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass

    # -- helpers --------------------------------------------------------
    def feature_mask_for(self, mask_flat: np.ndarray) -> torch.Tensor:
        """``[M, F_flat]`` masks reshaped to ``[M, *feature_shape]`` on the
        step's device (KUE masks a sample's features)."""
        return torch.as_tensor(np.asarray(mask_flat, np.float32)).reshape(
            self.M, *self.ds.feature_shape).to(self.step.device)

    def emit_assignment(self, t: int) -> None:
        """The per-iteration ``cluster_assign`` event: the client -> model
        vector, per-model client counts and, where the dataset carries
        ground-truth concepts, the live oracle ARI and purity."""
        assign = np.asarray(self.test_model_idx(t), dtype=np.int64)
        concepts = getattr(self.ds, "concepts", None)
        truth = None
        if concepts is not None and t < concepts.shape[0]:
            truth = np.asarray(concepts)[t, : self.C]
        counts = np.bincount(assign, minlength=self.M)
        fields: dict = {
            "assignment": assign.tolist(),
            "model_clients": {int(m): int(counts[m])
                              for m in np.nonzero(counts)[0]},
        }
        if truth is not None and len(assign):
            fields["oracle_ari"] = round(
                obs.lineage.adjusted_rand_index(truth, assign), 4)
            fields["oracle_purity"] = round(
                obs.lineage.cluster_purity(truth, assign), 4)
        obs.emit("cluster_assign", **fields)
