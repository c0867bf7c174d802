"""Host-side state-machine algorithms: DriftSurf, MultiModel (mmacc, mmgeni,
mmgeniex), Adaptive-FedAvg and the legacy one-shot ClusterFL.

Counterpart of ``feddrift_tpu/algorithms/statebased.py`` in dense mode (no
client is excluded as stale: the reference's behaviour at its default
``acc_staleness_limit`` of 0). The state machines run on the host over
numpy; the accuracies they score come from the batched ``[M, C]`` eval of
``TrainStep.acc_matrix``. DriftSurf and MultiModel run on the fused path;
Adaptive-FedAvg (its LR scale changes every round) and ClusterFL (its
split test reads every round's client updates) run round by round, and
each fetches from the device once a round.
"""

from __future__ import annotations

import numpy as np
import scipy.cluster.hierarchy as sch
import torch

from feddrift_torch import obs
from feddrift_torch.algorithms.base import DriftAlgorithm, register_algorithm
from feddrift_torch.config import DEFAULT_DELTAS
from feddrift_torch.data.retrain import is_retrain_spec, time_weights


def _host(params: dict) -> dict:
    """A snapshot of one model's leaves, apart from the pool's tensors."""
    return {k: v.detach().clone() for k, v in params.items()}


@register_algorithm("driftsurf")
class DriftSurf(DriftAlgorithm):
    """Stable/reactive drift-detection state machine (reference
    ``DriftSurf``). Two live model slots; slot i holds the model of
    ``train_keys[i]`` ('pred' always, plus 'stab' or 'reac'); each key's
    params carry across steps in ``key_params``."""

    name = "driftsurf"

    def __init__(self, cfg, ds, pool, step) -> None:
        super().__init__(cfg, ds, pool, step)
        assert self.M == 2
        self.delta = cfg.algo_params()["delta"]
        self.reac_len = 3                       # r = 3
        self.win_len = 10                       # batch-window cap
        self.key_params = {"pred": None, "stab": None, "reac": None}
        self.train_data = {"pred": [0], "stab": [0], "reac": None}
        self.train_keys = ["pred", "stab"]
        self.acc_best = 0.0
        self.acc_dict = None
        self.reac_ctr = None
        self.state = "stab"
        self.model_key = "pred"
        self._tw = None

    # ------------------------------------------------------------------
    def _score(self, key: str, t: int) -> float:
        """Pooled accuracy of the stored model of ``key`` on step-t data."""
        if self.key_params[key] is None:
            return 0.0
        params = {k: v[None] for k, v in self.key_params[key].items()}
        correct, _, total = self.step.acc_matrix(params, self.x[:, t],
                                                 self.y[:, t])
        correct, total = correct.cpu().numpy(), total.cpu().numpy()
        return float(correct[0, : self.C].sum() / total[: self.C].sum())

    def _append(self, key: str, it: int) -> None:
        self.train_data[key].append(it)
        if len(self.train_data[key]) > self.win_len:
            self.train_data[key].pop(0)

    def _run_ds_algo(self, t: int) -> None:
        """The transition logic (reference ``_run_ds_algo``)."""
        acc_pred = self._score("pred", t)
        if acc_pred > self.acc_best:
            self.acc_best = acc_pred
        if self.state == "stab":
            acc_stab = 0.0 if not self.train_data["stab"] \
                else self._score("stab", t)
            if (acc_pred < self.acc_best - self.delta) or \
               (acc_pred < acc_stab - self.delta / 2):
                obs.emit("drift_detected", detector="driftsurf",
                         acc_pred=round(acc_pred, 4),
                         acc_best=round(self.acc_best, 4),
                         acc_stab=round(acc_stab, 4), threshold=self.delta)
                self.state = "reac"
                self.key_params["reac"] = None
                self.train_data["reac"] = []
                self.reac_ctr = 0
                self.acc_dict = {"pred": np.zeros(self.reac_len),
                                 "reac": np.zeros(self.reac_len)}
            else:
                self._append("pred", t)
                self._append("stab", t)
                self.train_keys = ["pred", "stab"]
        if self.state == "reac":
            if self.reac_ctr > 0:
                acc_reac = self._score("reac", t)
                self.acc_dict["pred"][self.reac_ctr - 1] = acc_pred
                self.acc_dict["reac"][self.reac_ctr - 1] = acc_reac
                self.model_key = "reac" if acc_reac > acc_pred else "pred"
            self._append("pred", t)
            self._append("reac", t)
            self.train_keys = ["pred", "reac"]
            self.reac_ctr += 1
            if self.reac_ctr == self.reac_len:
                self.state = "stab"
                self.key_params["stab"] = None
                self.train_data["stab"] = []
                if np.mean(self.acc_dict["pred"]) \
                        < np.mean(self.acc_dict["reac"]):
                    self.key_params["pred"] = self.key_params["reac"]
                    self.train_data["pred"] = list(self.train_data["reac"])
                    self.acc_best = float(np.amax(self.acc_dict["reac"]))
                    self.model_key = "pred"
                self.acc_dict = None
                self.reac_ctr = None

    # ------------------------------------------------------------------
    def begin_iteration(self, t: int) -> None:
        if t > 0:
            self._run_ds_algo(t)
        # a key's stored params go back into its slot; a fresh key starts
        # from the deterministic init
        for idx, key in enumerate(self.train_keys):
            if self.key_params[key] is not None:
                self.pool.set_slot(idx, self.key_params[key])
            else:
                self.pool.reinit_slot(idx)
        # each key's retrain window becomes sel-{steps} time weights
        w = np.zeros((self.M, self.C, self.T1), dtype=np.float32)
        for idx, key in enumerate(self.train_keys):
            spec = "sel-" + ",".join(str(i) for i in self.train_data[key])
            w[idx] = time_weights(spec, self.C, t, self.T1)
        self._tw = torch.from_numpy(w).to(self.step.device)

    def round_inputs(self, t: int, r: int):
        return self._tw, None, None, 1.0

    def chunkable(self, t: int) -> bool:
        return True

    def end_iteration(self, t: int) -> None:
        for idx, key in enumerate(self.train_keys):
            self.key_params[key] = _host(self.pool.slot(idx))

    def test_model_idx(self, t: int) -> np.ndarray:
        idx = self.train_keys.index(self.model_key) \
            if self.model_key in self.train_keys else 0
        return np.full((self.C,), idx, dtype=np.int64)

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"train_data": self.train_data, "train_keys": self.train_keys,
                "acc_best": self.acc_best, "acc_dict": self.acc_dict,
                "reac_ctr": self.reac_ctr, "state": self.state,
                "model_key": self.model_key,
                "key_params": {k: None if v is None else _host(v)
                               for k, v in self.key_params.items()}}

    def load_state_dict(self, d: dict) -> None:
        self.train_data = d["train_data"]
        self.train_keys = list(d["train_keys"])
        self.acc_best = float(d["acc_best"])
        self.acc_dict = d["acc_dict"]
        self.reac_ctr = d["reac_ctr"]
        self.state = d["state"]
        self.model_key = d["model_key"]
        self.key_params = {
            k: None if v is None else {n: p.to(self.pool.device)
                                       for n, p in v.items()}
            for k, v in d["key_params"].items()}


@register_algorithm("mmacc", "mmgeni", "mmgeniex")
class MultiModel(DriftAlgorithm):
    """Per-client best-model selection, a drift threshold spawning the next
    free model (reference ``MultiModel``). ``mmgeni`` and ``mmgeniex`` are
    oracles reading the ground-truth concept matrix; ``mmgeniex`` also
    predicts the test model one step ahead."""

    name = "multimodel"

    def __init__(self, cfg, ds, pool, step) -> None:
        super().__init__(cfg, ds, pool, step)
        self.delta = DEFAULT_DELTAS.get(cfg.base_dataset, 0.1)
        # train_data[m][c]: the steps client c contributed to model m
        self.train_data = [[[] for _ in range(self.C)] for _ in range(self.M)]
        self.train_idx = np.zeros((self.C,), dtype=np.int64)
        self.test_idx = np.zeros((self.C,), dtype=np.int64)
        self.acc_dict = np.zeros((self.C,))
        self.concepts = ds.concepts[:, : self.C]   # oracle truth [T1, C]
        self._tw = None

    def _assigned(self) -> list[int]:
        return [m for m in range(self.M)
                if any(self.train_data[m][c] for c in range(self.C))]

    # ------------------------------------------------------------------
    def _select_acc(self, t: int) -> None:
        if t == 0:
            for c in range(self.C):
                self.train_data[0][c].append(0)
            self.train_idx[:] = 0
            self.test_idx[:] = 0
            return
        assigned = self._assigned()
        next_free = next((m for m in range(self.M) if m not in assigned), -1)
        acc = self.acc_matrix_at(t)
        for c in range(self.C):
            best_model, best_acc = -1, 0.0
            for m in assigned:
                if acc[m, c] > best_acc:
                    best_acc, best_model = acc[m, c], m
            if self.acc_dict[c] - best_acc > self.delta and next_free != -1:
                obs.emit("drift_detected", client=c,
                         acc_drop=round(float(self.acc_dict[c] - best_acc), 4),
                         threshold=self.delta, best_model=int(best_model))
                if not any(self.train_data[next_free][cc]
                           for cc in range(self.C)):
                    obs.emit("cluster_create", model=int(next_free),
                             init_from=None, client=int(c))
                best_model = next_free
            self.train_data[best_model][c].append(t)
            self.train_idx[c] = best_model
            self.test_idx[c] = best_model

    def _select_geni(self, t: int) -> None:
        for c in range(self.C):
            m = int(self.concepts[t, c]) % self.M
            self.train_data[m][c].append(t)
            self.train_idx[c] = m
            self.test_idx[c] = m

    def _select_geniex(self, t: int) -> None:
        drift_steps = np.nonzero(self.concepts.any(axis=1))[0]
        min_cp = int(drift_steps[0]) if drift_steps.size else 10**9
        for c in range(self.C):
            m = int(self.concepts[t, c]) % self.M
            test_m = int(self.concepts[t + 1, c]) % self.M if t >= min_cp \
                else m
            self.train_data[m][c].append(t)
            self.train_idx[c] = m
            self.test_idx[c] = test_m

    # ------------------------------------------------------------------
    def begin_iteration(self, t: int) -> None:
        algo = self.cfg.concept_drift_algo
        if algo == "mmacc":
            self._select_acc(t)
        elif algo == "mmgeni":
            self._select_geni(t)
        else:
            self._select_geniex(t)
        # client c contributes steps train_data[m][c] to model m
        w = np.zeros((self.M, self.C, self.T1), dtype=np.float32)
        for m in range(self.M):
            for c in range(self.C):
                for it in self.train_data[m][c]:
                    w[m, c, it] = 1.0
        self._tw = torch.from_numpy(w).to(self.step.device)
        self.emit_assignment(t)

    def round_inputs(self, t: int, r: int):
        return self._tw, None, None, 1.0

    def chunkable(self, t: int) -> bool:
        return True

    def end_iteration(self, t: int) -> None:
        # arm the drift detector: each client's model's accuracy at the end
        acc = self.acc_matrix_at(t)
        for c in range(self.C):
            self.acc_dict[c] = acc[self.train_idx[c], c]

    def train_model_idx(self, t: int) -> np.ndarray:
        return self.train_idx.copy()

    def test_model_idx(self, t: int) -> np.ndarray:
        return self.test_idx.copy()

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"train_data": self.train_data, "train_idx": self.train_idx,
                "test_idx": self.test_idx, "acc_dict": self.acc_dict}

    def load_state_dict(self, d: dict) -> None:
        self.train_data = d["train_data"]
        self.train_idx = np.asarray(d["train_idx"], np.int64)
        self.test_idx = np.asarray(d["test_idx"], np.int64)
        self.acc_dict = np.asarray(d["acc_dict"])


@register_algorithm("ada")
class AdaptiveFedAvg(DriftAlgorithm):
    """Server-side adaptive learning rate from moment statistics of the
    aggregated params (reference ``AdaptiveFedAvg``): eta = min(eta0, eta0
    · gamma_hat / t), reaching the clients as K1's ``lr_scale``. Its
    ``after_round`` fetches the aggregated params every round (one host
    sync a round)."""

    name = "ada"

    def __init__(self, cfg, ds, pool, step) -> None:
        super().__init__(cfg, ds, pool, step)
        assert self.M == 1
        p = cfg.algo_params()
        self.retrain = p.get("ada_retrain", "win-1")
        self.update_each_round = p.get("ada_update", "round") == "round"
        self.beta1 = self.beta2 = self.beta3 = 0.5
        self.init_lr = cfg.lr
        self.eta = cfg.lr
        self.mu = None
        self.s = 0.0
        self.gam = 0.0
        self._tw = None

    def _ada_update(self, theta: np.ndarray, t: int) -> None:
        """The reference's ``_ada_update``, counting from 1."""
        t = t + 1
        prev_mu = self.mu if self.mu is not None else np.zeros(theta.shape)
        prev_s, prev_gam = self.s, self.gam
        if t != 1:
            prev_muh = prev_mu / (1 - self.beta1 ** (t - 1))
            prev_sh = prev_s / (1 - self.beta2 ** (t - 1))
        else:
            prev_muh = 0.0
            prev_sh = 0.0
        new_mu = self.beta1 * prev_mu + (1 - self.beta1) * theta
        new_s = self.beta2 * prev_s + \
            (1 - self.beta2) * float(np.mean((theta - prev_muh) ** 2))
        new_sh = new_s / (1 - self.beta2 ** t)
        ratio = new_sh / prev_sh if prev_sh != 0 else 1.0
        new_gam = self.beta3 * prev_gam + (1 - self.beta3) * ratio
        new_gamh = new_gam / (1 - self.beta3 ** t)
        self.eta = min(self.init_lr, self.init_lr * new_gamh / t)
        self.mu, self.s, self.gam = new_mu, new_s, new_gam

    def begin_iteration(self, t: int) -> None:
        w = time_weights(self.retrain, self.C, t, self.T1)
        self._tw = torch.from_numpy(w[None]).to(self.step.device)

    def round_inputs(self, t: int, r: int):
        # the reference hands lr_scale over as float32
        return self._tw, None, None, float(np.float32(self.eta
                                                      / self.init_lr))

    def after_round(self, t: int, r: int, prev_params, agg_params,
                    client_params, n):
        self.pool.params = agg_params
        if self.update_each_round or r == self.cfg.comm_round - 5:
            # theta in the reference's leaf order (flax's sorted keys)
            theta = torch.cat([agg_params[k][0].reshape(-1)
                               for k in sorted(agg_params)]).cpu().numpy()
            self._ada_update(theta, r + t * self.cfg.comm_round
                             if self.update_each_round else t)
        return self.pool.params

    def state_dict(self) -> dict:
        return {"eta": self.eta, "mu": self.mu, "s": self.s, "gam": self.gam}

    def load_state_dict(self, d: dict) -> None:
        self.eta = float(d["eta"])
        self.mu = None if d["mu"] is None else np.asarray(d["mu"])
        self.s = float(d["s"])
        self.gam = float(d["gam"])


def bipartition_labels(S: np.ndarray) -> np.ndarray:
    """scikit-learn's ``AgglomerativeClustering(metric="precomputed",
    linkage="complete", n_clusters=2).fit(-S).labels_`` without
    scikit-learn: scipy's complete linkage of the upper triangle of -S, the
    distances sklearn hands scipy, and sklearn's labelling of the root's
    two children: label 0 for the one with the larger node id."""
    n = S.shape[0]
    Z = sch.linkage(-S[np.triu_indices(n, k=1)], method="complete")
    labels = np.ones(n, dtype=np.int64)
    stack = [int(max(Z[-1, 0], Z[-1, 1]))]
    while stack:                        # the leaves under that child
        node = stack.pop()
        if node < n:
            labels[node] = 0
        else:
            stack += [int(Z[node - n, 0]), int(Z[node - n, 1])]
    return labels


@register_algorithm("clusterfl")
class LegacyClusterFL(DriftAlgorithm):
    """One-shot CFL bipartition inside a time step (reference
    ``LegacyClusterFL``): the split test on the single model's client
    updates every round until it splits, then two models; nothing carries
    across steps. Its ``after_round`` fetches n and the client params every
    round until the split."""

    name = "clusterfl"
    needs_client_params = True

    def __init__(self, cfg, ds, pool, step) -> None:
        super().__init__(cfg, ds, pool, step)
        # a retrain-window spec; any other string (the default
        # "H_A_C_1_10_0") means win-1, as in the reference
        arg = cfg.concept_drift_algo_arg
        if not arg or not is_retrain_spec(arg, self.C, self.T1):
            arg = "win-1"
        self.retrain = arg
        self.gamma_max = 0.5
        self._reset_state()

    def _reset_state(self) -> None:
        self.is_split = False
        self.assignment = np.zeros((self.C,), dtype=np.int64)
        self.eps1 = 0.0
        self.eps2 = 1e4
        self.max_eps1 = 0.0

    def begin_iteration(self, t: int) -> None:
        self._reset_state()
        for m in range(self.M):
            self.pool.reinit_slot(m)
        self._base_w = time_weights(self.retrain, self.C, t, self.T1)
        self._sync_weights()

    def _sync_weights(self) -> None:
        w = np.zeros((self.M, self.C, self.T1), dtype=np.float32)
        for c in range(self.C):
            w[self.assignment[c], c] = self._base_w[c]
        self._tw = torch.from_numpy(w).to(self.step.device)

    def round_inputs(self, t: int, r: int):
        return self._tw, None, None, 1.0

    def after_round(self, t: int, r: int, prev_params, agg_params,
                    client_params, n):
        self.pool.params = agg_params
        if self.is_split:
            return self.pool.params
        # model 0's updates of the participating clients (n > 0), in one
        # copy; the coordinates' order moves no norm and no cosine
        mod = self.pool.module
        cp = mod.pack(client_params)[0]                        # [C, P]
        delta = cp - mod.pack(prev_params)[0][None]
        host = torch.cat([n[0].to(cp.dtype), delta.reshape(-1),
                          cp.reshape(-1)]).cpu().numpy()
        C = n.shape[1]
        n0 = host[:C][: self.C]
        delta = host[C: C + delta.numel()].reshape(delta.shape)
        cp = host[C + delta.size:].reshape(delta.shape)
        part = np.where(n0 > 0)[0]
        if len(part) < 2:
            return self.pool.params
        dW = delta[: self.C][part]
        norms = np.linalg.norm(dW, axis=1)
        max_norm = float(norms.max())
        mean_norm = float(np.linalg.norm(dW.mean(axis=0)))
        if self.logger:
            self.logger.set_summary("Max_Norm", max_norm)
            self.logger.set_summary("Mean_Norm", mean_norm)
        mean_norm_increase = False
        if mean_norm > self.max_eps1:
            self.max_eps1 = mean_norm
            mean_norm_increase = True
            self.eps1 = self.max_eps1 / 10.0
            self.eps2 = 6 * self.eps1
        if mean_norm < self.eps1 and max_norm > self.eps2 and r > 100 \
                and not mean_norm_increase:
            S = (dW @ dW.T) / (np.outer(norms, norms) + 1e-12)
            labels = bipartition_labels(S)
            c1, c2 = part[labels == 0], part[labels == 1]
            self.assignment[c1] = 0
            self.assignment[c2] = 1
            self.is_split = True
            obs.emit("cluster_split", model=0, new_model=1,
                     clients_kept=c1.tolist(), clients_moved=c2.tolist(),
                     mean_norm=round(mean_norm, 6),
                     max_norm=round(max_norm, 6))
            # this round's model-0 uploads, re-aggregated per new cluster
            for m_idx, cl in enumerate((c1, c2)):
                wsum = n0[cl].sum()
                if wsum <= 0:
                    continue
                wts = (n0[cl] / wsum).astype(np.float32)
                merged = (cp[cl] * wts[:, None]).sum(axis=0)
                self.pool.set_slot(m_idx, mod.unpack(
                    torch.from_numpy(merged).to(self.pool.device)))
            self._sync_weights()
        return self.pool.params

    def test_model_idx(self, t: int) -> np.ndarray:
        return self.assignment.copy()

    def state_dict(self) -> dict:
        return {"is_split": self.is_split, "assignment": self.assignment,
                "eps1": self.eps1, "eps2": self.eps2,
                "max_eps1": self.max_eps1}

    def load_state_dict(self, d: dict) -> None:
        self.is_split = bool(d["is_split"])
        self.assignment = np.asarray(d["assignment"], np.int64)
        self.eps1, self.eps2 = float(d["eps1"]), float(d["eps2"])
        self.max_eps1 = float(d["max_eps1"])
