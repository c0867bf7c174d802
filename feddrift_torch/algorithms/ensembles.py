"""Streaming-ensemble baselines: AUE, AUE-PC and KUE.

Counterpart of ``feddrift_tpu/algorithms/ensembles.py``. Accuracy-Updated
Ensemble (AUE, and AUE-PC with per-client weights) keeps a sliding window
of models, the m-th trained on the last m + 1 steps, voting with weights
from their Brier (MSE) scores. Kappa-Updated Ensemble (KUE) keeps
``concept_num`` models, each with a random feature mask and its own
Poisson(1) bootstrap of the newest step, voting softly with Cohen's kappa;
each step its lowest-kappa model is re-masked and re-initialised. All three
run on the per-round path: every tenth round and the last ten they fetch
the ``[M, C]`` MSE matrix (AUE) or the ``[M, C, K, K]`` confusion matrices
(KUE) from the device, and their test accuracy is the ensemble's vote
(``TrainStep.ensemble_eval``). KUE's masks and counts come from
``np.random.default_rng(seed + 31337)``, the reference's stream.
"""

from __future__ import annotations

import numpy as np
import torch

from feddrift_torch import obs
from feddrift_torch.algorithms.base import (DriftAlgorithm, EnsembleSpec,
                                            register_algorithm)
from feddrift_torch.data.retrain import poisson_sample_counts, time_weights

EPS = 1e-20


def kappa_from_confusion(A: np.ndarray) -> float:
    """Cohen's kappa from a summed ``[K, K]`` confusion matrix (rows the
    truth), 0 where its denominator is 0 (the reference's guard)."""
    n = A.sum()
    left = np.trace(A)
    right = (A.sum(axis=1) * A.sum(axis=0)).sum()
    denom = n * n - right
    return float((n * left - right) / denom) if denom != 0 else 0.0


class _AueBase(DriftAlgorithm):
    """AUE's window of models and MSE weights; subclasses pick global or
    per-client weights."""

    per_client_weights = False

    def __init__(self, cfg, ds, pool, step) -> None:
        super().__init__(cfg, ds, pool, step)
        self.W = cfg.ensemble_window
        assert self.M == self.W
        py = 1.0 / ds.num_classes
        self.mser = (1.0 - py) ** 2
        shape = (self.C, self.M) if self.per_client_weights else (self.M,)
        self.ens_weights = np.full(shape, 1.0 / (self.mser + EPS))
        self._normalize()
        self.model_num = 1
        self._tw = None

    def _normalize(self) -> None:
        if self.per_client_weights:
            self.ens_weights /= self.ens_weights.sum(axis=1, keepdims=True)
        else:
            self.ens_weights /= self.ens_weights.sum()

    def begin_iteration(self, t: int) -> None:
        # the window grows until it holds W models
        self.model_num = min(t + 1, self.W)
        if t > 0:
            # model m takes over last step's model m - 1; model 0 restarts
            # from the deterministic init, its weight "perfect"
            for m in reversed(range(1, self.model_num)):
                self.pool.copy_slot(m, m - 1)
            self.pool.reinit_slot(0)
            obs.emit("model_replaced", model=0, reason="aue_window_shift",
                     window=int(self.model_num))
            if self.per_client_weights:
                self.ens_weights[:, 1:] = self.ens_weights[:, :-1]
                self.ens_weights[:, 0] = 1.0 / (self.mser + EPS)
            else:
                self.ens_weights[1:] = self.ens_weights[:-1]
                self.ens_weights[0] = 1.0 / (self.mser + EPS)
            self._normalize()
        # model m trains on the window win-(m + 1)
        w = np.zeros((self.M, self.C, self.T1), dtype=np.float32)
        for m in range(self.model_num):
            w[m] = time_weights(f"win-{m + 1}", self.C, t, self.T1)
        self._tw = torch.from_numpy(w).to(self.step.device)

    def round_inputs(self, t: int, r: int):
        return self._tw, None, None, 1.0

    def _update_ens_weights(self, t: int) -> None:
        """1 / (MSEr + MSEi + eps) from the newest step's data (weight m
        from model m's MSE, the AUE paper's formula, as the reference)."""
        mse_sum, total = self.step.mse_matrix(self.pool.params, self.x[:, t],
                                              self.y[:, t])
        k = mse_sum.numel()                 # one fetch for both
        host = torch.cat([mse_sum.reshape(-1),
                          total.to(mse_sum.dtype)]).cpu().numpy()
        total = host[k:].astype(np.int32)[: self.C]
        mse_sum = host[:k].reshape(mse_sum.shape)[:, : self.C]
        if self.per_client_weights:
            msei = mse_sum.T / np.maximum(total[:, None], 1)    # [C, M]
            self.ens_weights = 1.0 / (self.mser + msei + EPS)
            self.ens_weights[:, 0] = 1.0 / (self.mser + EPS)
        else:
            msei = mse_sum.sum(axis=1) / max(total.sum(), 1)    # [M]
            self.ens_weights = 1.0 / (self.mser + msei + EPS)
            self.ens_weights[0] = 1.0 / (self.mser + EPS)
        self._normalize()

    def after_round(self, t: int, r: int, prev_params, agg_params,
                    client_params, n):
        self.pool.params = agg_params
        if r % 10 == 0 or r > self.cfg.comm_round - 10:
            self._update_ens_weights(t)
        return self.pool.params

    def train_model_idx(self, t: int) -> np.ndarray:
        # train metrics come from the newest model
        return np.zeros((self.C,), dtype=np.int64)

    test_model_idx = train_model_idx

    def ensemble_spec(self, t: int):
        mask = np.zeros((self.M,), dtype=np.float32)
        mask[: self.model_num] = 1.0
        w = self.ens_weights.T if self.per_client_weights else self.ens_weights
        return EnsembleSpec(mode="hard", weights=np.asarray(w, np.float32),
                            model_mask=mask)

    def state_dict(self) -> dict:
        return {"ens_weights": self.ens_weights, "model_num": self.model_num}

    def load_state_dict(self, d: dict) -> None:
        self.ens_weights = np.asarray(d["ens_weights"])
        self.model_num = int(d["model_num"])


@register_algorithm("aue")
class Aue(_AueBase):
    name = "aue"
    per_client_weights = False


@register_algorithm("auepc")
class AuePc(_AueBase):
    """AUE with per-client ensemble weights."""
    name = "auepc"
    per_client_weights = True


@register_algorithm("kue")
class Kue(DriftAlgorithm):
    """Kappa-Updated Ensemble (reference ``Kue``): per-model feature masks
    and Poisson(1) sample weights, trained through the weighted draw (K4)
    and K1's gather route; a kappa-weighted soft vote over the models of
    kappa > 0, the worst model left out."""

    name = "kue"
    uses_sample_weights = True   # Poisson-bootstrap sample_w in round_inputs

    def __init__(self, cfg, ds, pool, step) -> None:
        super().__init__(cfg, ds, pool, step)
        # one mask slot a sequence, whose tokens are never masked
        self.F = int(np.prod(ds.feature_shape)) if not ds.is_sequence else 1
        self.rng = np.random.default_rng(cfg.seed + 31337)
        self.masks = np.zeros((self.M, self.F), dtype=np.float32)
        for m in range(self.M):
            self._init_mask(m)
        self.worst_idx = 0
        self.ens_weights = np.zeros((self.M,), dtype=np.float64)
        self._tw = self._sw = self._fm = None

    def _init_mask(self, m: int) -> None:
        """r ~ U{1..F} features on."""
        r = int(self.rng.integers(1, self.F + 1))
        used = self.rng.choice(self.F, size=r, replace=False)
        self.masks[m] = 0.0
        self.masks[m][used] = 1.0

    def begin_iteration(self, t: int) -> None:
        if t > 0:
            # replace the worst model: a new mask, the deterministic init
            self._init_mask(self.worst_idx)
            self.pool.reinit_slot(self.worst_idx)
            obs.emit("model_replaced", model=int(self.worst_idx),
                     reason="kue_worst_kappa",
                     kappa=round(float(self.ens_weights[self.worst_idx]), 4),
                     kappa_all=[round(float(k), 4)
                                for k in self.ens_weights])
        # the current step, and each model's own bootstrap of it
        w = time_weights("win-1", self.C, t, self.T1)
        dev = self.step.device
        self._tw = torch.from_numpy(np.broadcast_to(
            w[None], (self.M, self.C, self.T1)).copy()).to(dev)
        counts = np.stack([poisson_sample_counts(self.C, self.N, self.rng)
                           for _ in range(self.M)])
        self._sw = torch.from_numpy(counts).to(dev)
        self._fm = self.feature_mask_for(self.masks)

    def round_inputs(self, t: int, r: int):
        return self._tw, self._sw, self._fm, 1.0

    def _update_ens_weights(self, t: int) -> None:
        """Cohen's kappa of each model from its confusion matrices summed
        over the clients."""
        cms = self.step.confusion_matrices(self.pool.params, self.x[:, t],
                                           self.y[:, t], self._fm)
        cms = cms.cpu().numpy().astype(np.float64)[:, : self.C].sum(axis=1)
        for m in range(self.M):
            self.ens_weights[m] = kappa_from_confusion(cms[m])

    def after_round(self, t: int, r: int, prev_params, agg_params,
                    client_params, n):
        self.pool.params = agg_params
        if r % 10 == 0 or r > self.cfg.comm_round - 10:
            self._update_ens_weights(t)
            if t != 0:
                self.worst_idx = int(np.argmin(self.ens_weights))
        return self.pool.params

    def train_model_idx(self, t: int) -> np.ndarray:
        return np.zeros((self.C,), dtype=np.int64)

    test_model_idx = train_model_idx

    def ensemble_spec(self, t: int):
        mask = np.ones((self.M,), dtype=np.float32)
        mask[self.worst_idx] = 0.0                   # the worst is left out
        return EnsembleSpec(mode="soft",
                            weights=np.asarray(self.ens_weights, np.float32),
                            model_mask=mask)

    def state_dict(self) -> dict:
        return {"masks": self.masks, "worst_idx": self.worst_idx,
                "ens_weights": self.ens_weights,
                "rng_state": self.rng.bit_generator.state}

    def load_state_dict(self, d: dict) -> None:
        self.masks = np.asarray(d["masks"], np.float32)
        self.worst_idx = int(d["worst_idx"])
        self.ens_weights = np.asarray(d["ens_weights"], np.float64)
        if "rng_state" in d:
            self.rng.bit_generator.state = d["rng_state"]
