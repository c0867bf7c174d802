"""The SoftCluster family: FedDrift, FedDrift-Eager, IFCA, CFL, softmax and
the change-point oracle.

Counterpart of ``feddrift_tpu/algorithms/softcluster.py::SoftCluster`` in
dense mode. The time-indexed weights are a dense ``[T1, M, C]`` numpy
tensor; accuracy matrices and cells come from the device
(``TrainStep.acc_matrix``/``acc_cells``); the decisions (drift detection,
LRU model slots, the hierarchical merge through scipy's linkage, CFL's
bipartition) stay host-side numpy on O(M^2) matrices, as in the reference.
The same seed and the same accuracy inputs (for CFL, the same client
updates) give the same weights, merges, spawns, splits, LRU picks and
events. Kinds, from ``concept_drift_algo_arg``:

  'H_*'              FedDrift hierarchical clustering
  'mmacc_*'          FedDrift-Eager: drift detection, one spawn a step
  'hard' / 'hard-r'  IFCA; '-r' re-clusters after every round
  'softmax_{alpha}'  softmax weights over the accuracies
  'gmm'              a two-component Gaussian mixture over the clients'
                     accuracy rows (``algorithms/gmm.py``: scikit-learn's
                     GaussianMixture, computed without it)
  'geni'             the change-point oracle (the dataset's concepts)
  'cfl_{gamma}_{rt}' clustered FL: bipartition from client updates

``softclusterwin-1`` zeroes the weights of past steps; ``softclusterreset``
deletes non-competitive models. Every client counts as live (the port has
no failure detector, so no accuracy is stale).
"""

from __future__ import annotations

import numpy as np
import scipy.cluster.hierarchy as sch
import torch
from scipy.spatial.distance import squareform
from scipy.special import softmax as sp_softmax

from feddrift_torch import obs
from feddrift_torch.algorithms.base import DriftAlgorithm, register_algorithm
from feddrift_torch.algorithms.gmm import GaussianMixture


@register_algorithm("softcluster", "softclusterwin-1", "softclusterreset")
class SoftCluster(DriftAlgorithm):
    name = "softcluster"

    def __init__(self, cfg, ds, pool, step) -> None:
        super().__init__(cfg, ds, pool, step)
        p = cfg.algo_params()
        self.kind = p["kind"]
        self.p = p
        # dense [T1, M, C] replaces the reference's {t -> M x C} dict
        self.weights = np.zeros((self.T1, self.M, self.C), dtype=np.float32)
        self.mmacc_acc = np.zeros(self.C)           # per-client last best acc
        self.mmacc_delta = p.get("mmacc_delta", p.get("h_delta", 0.1))
        self.h_delta = p.get("h_delta", 0.1)
        self.h_deltap = p.get("h_deltap", 0.1)
        self.h_w = p.get("h_w", 1)
        self.h_distance = p.get("h_distance", "A")
        self.h_cluster = p.get("h_cluster", "C")
        self.h_marked: dict[int, tuple[int, int]] = {}   # client -> (model, unmark t)
        self.h_next_free = 1
        self.cfl_gamma = p.get("cfl_gamma", 0.1)
        self.cfl_retrain = p.get("cfl_retrain", "win-1")
        self.cfl_norm = 0.0
        self.cfl_eps1 = 0.0
        self.cfl_eps2 = 1e4
        if self.kind == "geni":
            self.geni_concepts = ds.concepts[:, : self.C]
        self.rng = np.random.default_rng(cfg.seed + 1009)
        self.event_counts = {"spawns": 0, "merges": 0, "linkage_calls": 0}
        self._tw = None
        # only CFL reads the per-client updates in after_round
        self.needs_client_params = self.kind == "cfl"

    # ------------------------------------------------------------------
    def _models_in_use_before(self, t: int,
                              exclude_marked: bool = False) -> list[int]:
        """Models with any weight before step t."""
        marked = {m for (m, _) in self.h_marked.values()} \
            if exclude_marked else set()
        used = {m for m in range(self.M) if (self.weights[:t, m, :] > 0).any()}
        return [m for m in sorted(used) if m not in marked]

    def _sync_device_weights(self) -> None:
        # [T1, M, C] -> [M, C, T1] on the train step's device
        self._tw = torch.from_numpy(
            np.ascontiguousarray(np.transpose(self.weights, (1, 2, 0)))
        ).to(self.step.device)

    def round_inputs(self, t: int, r: int):
        return self._tw, None, None, 1.0

    def chunkable(self, t: int) -> bool:
        # cfl checks for a split after every round and hard-r re-clusters
        # after every round: both steer the rounds one at a time
        return self.kind not in ("cfl", "hard-r")

    def test_model_idx(self, t: int) -> np.ndarray:
        return np.argmax(self.weights[t], axis=0)

    # ------------------------------------------------------------------
    def begin_iteration(self, t: int) -> None:
        acc_t = None   # the [M, C] acc matrix at step 0, if computed
        if t == 0:
            self._cluster_init()
            if self.kind in ("hard", "hard-r"):
                # IFCA symmetry breaking: distinct random models at t = 0
                for m in range(self.M):
                    self.pool.distinct_reinit_slot(
                        m, seed=self.cfg.seed + 7700 + m)
                acc_t = self.acc_matrix_at(0)
                self._cluster(acc_t, 0, round_idx=0)
        elif self.kind == "hierarchical":
            self._cluster_hierarchical(t)
        elif self.kind == "mmacc":
            self._cluster_mmacc2(t)
        elif self.kind == "cfl":
            self._cluster_cfl_init(t)
        elif self.kind in ("hard", "hard-r"):
            # IFCA clusters only; the reset variant never applies to it
            self._cluster(self.acc_matrix_at(t), t, round_idx=0)
        else:
            # the reference's final branch: the reset variant applies here
            if self.cfg.concept_drift_algo == "softclusterreset":
                self._reset_noncompetitive(t)
            self._cluster(self.acc_matrix_at(t), t, round_idx=0)

        if self.cfg.concept_drift_algo == "softclusterwin-1":
            self.weights[:t] = 0.0

        if t == 0:
            # arm the drift detector with the initial accuracies
            acc = acc_t if acc_t is not None else self.acc_matrix_at(0)
            idx = self.test_model_idx(0)
            for c in range(self.C):
                self.mmacc_acc[c] = acc[idx[c], c]
        self._log_models(t)
        self._sync_device_weights()

    def after_round(self, t: int, r: int, prev_params, agg_params,
                    client_params, n):
        if self.kind == "cfl" and self._cluster_cfl_round(
                t, prev_params, client_params, n):
            # a split skips this round's aggregation: the local updates
            # belong to the assignment before the split
            self._sync_device_weights()
            return self.pool.params
        self.pool.params = agg_params
        if self.kind == "hard-r":
            self._cluster(self.acc_matrix_at(t), t, round_idx=r + 1)
            self._sync_device_weights()
        return self.pool.params

    def _cluster_init(self) -> None:
        """Everyone on model 0, or one model per client for FedDrift-F."""
        self.weights[0] = 0.0
        if self.h_cluster == "F" and self.kind == "hierarchical":
            if self.M < self.C:
                raise ValueError(
                    f"h_cluster='F' needs concept_num >= clients "
                    f"({self.M} < {self.C})")
            for c in range(self.C):
                self.weights[0, c, c] = 1.0
            self.h_next_free = self.C
        else:
            self.weights[0, 0, :] = 1.0

    def _cluster(self, acc: np.ndarray, t: int, round_idx: int) -> None:
        """The kinds that cluster from one accuracy matrix."""
        if self.kind in ("hard", "hard-r"):
            self.weights[t] = 0.0
            best = np.argmax(acc, axis=0)
            self.weights[t, best, np.arange(self.C)] = 1.0
        elif self.kind == "softmax":
            alpha = self.p.get("softmax_alpha", 0)
            self.weights[t] = sp_softmax(acc * (2**alpha), axis=0)
        elif self.kind == "gmm":
            self._cluster_gmm(acc, t)
        elif self.kind == "geni":
            if round_idx == 0:
                self.weights[t] = 0.0
                best = self.geni_concepts[t] % self.M
                self.weights[t, best, np.arange(self.C)] = 1.0
        else:
            raise NameError(self.kind)

    def _cluster_gmm(self, acc: np.ndarray, t: int) -> None:
        """Models 0 and 1 share each client by a two-component mixture over
        the clients' accuracy rows ``acc.T [C, M]``; the component whose
        mean puts model 0 above model 1 goes to model 0 (the reference's
        swap on ``means_[0][0] > means_[0][1]``, as written)."""
        self.weights[t] = 0.0
        gm = GaussianMixture().fit(acc.T)
        probs = gm.predict_proba(acc.T).T
        if gm.means_[0][0] > gm.means_[0][1]:
            self.weights[t, 0], self.weights[t, 1] = probs[0], probs[1]
        else:
            self.weights[t, 0], self.weights[t, 1] = probs[1], probs[0]

    # ------------------------------------------------------------------
    def _cluster_mmacc2(self, t: int) -> None:
        """FedDrift-Eager: drift detection and at most one new model a
        step, no merge (cluster_mmacc2)."""
        acc = self.acc_matrix_at(t)
        in_use = self._models_in_use_before(t)
        self.weights[t] = 0.0
        best = np.asarray(in_use)[np.argmax(acc[in_use], axis=0)]
        self.weights[t, best, np.arange(self.C)] = 1.0

        next_free = -42
        for c in range(self.C):
            newest_acc = acc[best[c], c]
            drop = self.mmacc_acc[c] - newest_acc
            if drop > self.mmacc_delta:
                obs.emit("drift_detected", client=c,
                         acc_drop=round(float(drop), 4),
                         threshold=self.mmacc_delta,
                         best_model=int(best[c]))
                if next_free == -42:
                    next_free = self._find_unused_model_lru(
                        t, original_model=best[c], client=c)
                if next_free != -1:
                    self.event_counts["spawns"] += 1
                    self.weights[t, :, c] = 0.0
                    self.weights[t, next_free, c] = 1.0
            self.mmacc_acc[c] = newest_acc

    # ------------------------------------------------------------------
    def _cluster_hierarchical(self, t: int) -> None:
        """The FedDrift algorithm (cluster_hierarchical, :840-978)."""
        # FedDrift-C: keep only one of the models created last step
        if self.h_cluster == "E":
            marked_models = [m for (m, _) in self.h_marked.values()]
            if marked_models:
                keep = self.rng.choice(marked_models)
                for mm in marked_models:
                    if mm != keep:
                        self.pool.reinit_slot(mm)
                        self.weights[:, mm, :] = 0.0
                        obs.emit("cluster_delete", model=int(mm),
                                 reason="feddrift_c_keep_one")

        # clients leave isolation
        self.h_marked = {c: (m, tt) for c, (m, tt) in self.h_marked.items()
                         if tt != t}

        in_use = self._models_in_use_before(t, exclude_marked=True)
        acc = self.acc_matrix_at(t)                       # device: [M, C]

        self.weights[t] = 0.0
        for c, (m, _) in self.h_marked.items():           # marked stay local
            self.weights[t, m, c] = 1.0
        for c in range(self.C):                           # best in-use model
            if c not in self.h_marked:
                best = in_use[int(np.argmax(acc[in_use, c]))]
                self.weights[t, best, c] = 1.0

        # drift detection -> isolate on a fresh model
        for c in range(self.C):
            if c in self.h_marked:
                continue
            best = in_use[int(np.argmax(acc[in_use, c]))]
            newest_acc = acc[best, c]
            if self.mmacc_acc[c] - newest_acc > self.h_delta:
                obs.emit("drift_detected", client=c,
                         acc_drop=round(float(self.mmacc_acc[c] - newest_acc), 4),
                         threshold=self.h_delta, best_model=int(best))
                next_free = self._find_unused_model_lru(
                    t, original_model=best, client=c)
                if next_free != -1:
                    self.event_counts["spawns"] += 1
                    self.h_marked[c] = (next_free, t + self.h_w)
                    self.weights[t, :, c] = 0.0
                    self.weights[t, next_free, c] = 1.0
            self.mmacc_acc[c] = newest_acc

        if len(in_use) > 1:
            self._hierarchical_merge(t, in_use)

    def _hierarchical_merge(self, t: int, in_use: list[int]) -> None:
        """Cluster-accuracy matrix -> distance -> linkage -> merge, from
        full per-cell correct counts."""
        cells = self.acc_cells_upto(t)                    # [M, C, t+1] correct
        w = np.transpose(self.weights[: t + 1], (1, 2, 0))  # [M, C, t+1]
        assigned = (w == 1.0).astype(np.float64)
        k = len(in_use)
        cluster_acc = np.zeros((k, k))
        for j_pos, j in enumerate(in_use):
            vol = assigned[j].sum() * self.N
            if vol == 0:
                continue
            for i_pos, i in enumerate(in_use):
                cluster_acc[i_pos, j_pos] = (cells[i] * assigned[j]).sum() / vol

        dist = np.zeros((k, k))
        for i in range(k):
            for j in range(k):
                if self.h_distance == "A":
                    dist[i, j] = max(cluster_acc[i, i] - cluster_acc[i, j],
                                     cluster_acc[j, j] - cluster_acc[j, i], 0.0)
                elif self.h_distance == "B":
                    dist[i, j] = max(cluster_acc[i, i] - cluster_acc[j, i],
                                     cluster_acc[j, j] - cluster_acc[i, j], 0.0)
        np.fill_diagonal(dist, 0.0)

        method = "average" if self.h_cluster == "D" else "complete"
        self.event_counts["linkage_calls"] += 1
        Z = sch.linkage(squareform(dist, checks=False), method=method)
        T = sch.fcluster(Z, t=self.h_deltap, criterion="distance")

        clusters: dict[int, list[int]] = {}
        for pos, cid in enumerate(T):
            clusters.setdefault(cid, []).append(in_use[pos])

        merged_log = []
        for group in clusters.values():
            if len(group) > 1:
                merged_log.append("(" + ", ".join(str(m) for m in group) + ")")
            base = group[0]
            base_pos = in_use.index(base)
            for second in group[1:]:
                second_pos = in_use.index(second)
                self._merge(t, base, second, evidence={
                    "distance": round(float(dist[base_pos, second_pos]), 4),
                    "threshold": self.h_deltap,
                    "in_use": [int(m) for m in in_use],
                    "distance_row": [round(float(d), 4)
                                     for d in dist[second_pos]],
                })
        if merged_log and self.logger:
            self.logger.set_summary("Merge", ", ".join(merged_log))

    def _merge(self, t: int, base: int, second: int,
               evidence: dict | None = None) -> None:
        """Weighted param average + weight union."""
        self.event_counts["merges"] += 1
        obs.emit("cluster_merge", base=int(base), merged=int(second),
                 **(evidence or {}))
        w1 = float(self.weights[: t + 1, base, :].sum())
        w2 = float(self.weights[: t + 1, second, :].sum())
        s = w1 + w2
        self.pool.merge_slots(base, second, w1 / s, w2 / s)
        self.weights[: t + 1, base, :] += self.weights[: t + 1, second, :]
        self.weights[:, second, :] = 0.0

    def _find_unused_model_lru(self, t: int, original_model: int,
                               client: int | None = None) -> int:
        """LRU slot allocation; the new slot starts from the drifted
        client's previous model."""
        if self.h_next_free < self.M:
            nxt = self.h_next_free
            self.h_next_free += 1
        else:
            last_used = -1 * np.ones(self.M)
            for tt in range(t + 1):
                for m in range(self.M):
                    if (self.weights[tt, m] > 0).any():
                        last_used[m] = tt
            lru = np.where(last_used == last_used.min())[0]
            nxt = int(self.rng.choice(lru))
            if last_used[nxt] == t:
                return -1
            self.weights[:, nxt, :] = 0.0
        self.pool.copy_slot(nxt, original_model)
        obs.emit("cluster_create", model=int(nxt),
                 init_from=int(original_model),
                 client=None if client is None else int(client))
        return nxt

    # ------------------------------------------------------------------
    def _reset_noncompetitive(self, t: int) -> None:
        """softclusterreset: delete the models that are not 0.01 better
        than the rest on some client."""
        acc = self.acc_matrix_at(t)
        deleted: list[int] = []
        for m in reversed(range(self.M)):
            rest = np.delete(acc, deleted + [m], axis=0)
            if rest.shape[0] > 0 \
                    and (acc[m] < np.max(rest, axis=0) + 0.01).all():
                deleted.append(m)
                if self.logger:
                    self.logger.set_summary(f"Reset-{m}", 1)
                self.weights[:, m, :] = 0.0
                self.pool.reinit_slot(m)
                obs.emit("cluster_delete", model=int(m),
                         reason="noncompetitive_reset")

    # ------------------------------------------------------------------
    def _cluster_cfl_init(self, t: int) -> None:
        """Carry the assignment into step t (cluster_cfl_init)."""
        self.weights[t] = self.weights[t - 1].copy()
        if self.cfl_retrain == "win-1":
            self.weights[:t] = 0.0

    def _client_updates(self, prev_params, client_params,
                        n) -> tuple[np.ndarray, np.ndarray]:
        """``(n [M, C], updates [M, C, P])`` on the host, in one copy: each
        model's client params minus its round-start params, packed (the
        order of the coordinates moves no norm and no cosine)."""
        mod = self.pool.module
        delta = mod.pack(client_params) - mod.pack(prev_params)[:, None]
        host = torch.cat([n.reshape(-1).to(delta.dtype),
                          delta.reshape(-1)]).cpu().numpy()
        return (host[: n.numel()].reshape(n.shape)[:, : self.C],
                host[n.numel():].reshape(delta.shape))

    def _cluster_cfl_round(self, t: int, prev_params, client_params,
                           n) -> bool:
        """Gradient-norm gated bipartition of each cluster's participating
        clients (cluster_cfl). Returns True when a cluster split."""
        did_split = False
        in_use = [m for m in range(self.M) if (self.weights[t, m] > 0).any()]
        n_np, updates = self._client_updates(prev_params, client_params, n)
        for m in in_use:
            clients = np.nonzero(self.weights[t, m])[0]
            participating = [c for c in clients if n_np[m, c] > 0]
            if not participating:
                continue
            dW = updates[m][participating]
            norms = np.linalg.norm(dW, axis=1)
            max_norm = float(norms.max())
            mean_norm = float(np.linalg.norm(dW.mean(axis=0)))

            if mean_norm > self.cfl_norm:
                self.cfl_norm = mean_norm
                self.cfl_eps1 = self.cfl_norm / 10.0
                self.cfl_eps2 = 6 * self.cfl_eps1
            elif mean_norm < self.cfl_eps1 and max_norm > self.cfl_eps2:
                S = (dW @ dW.T) / (np.outer(norms, norms) + 1e-12)
                cl1, cl2 = self._bipartition(S)
                alpha_cross = max(S[i, j] for i in cl1 for j in cl2)
                if ((1 - alpha_cross) / 2.0) ** 0.5 > self.cfl_gamma:
                    nxt = self._find_unused_model_capped()
                    if nxt != -1:
                        did_split = True
                        self.pool.reinit_slot(m)
                        self.weights[t, m, :] = 0.0
                        for i in cl1:
                            self.weights[t, m, participating[i]] = 1.0
                        for i in cl2:
                            self.weights[t, nxt, participating[i]] = 1.0
                        obs.emit(
                            "cluster_split", model=int(m), new_model=int(nxt),
                            clients_kept=[int(participating[i]) for i in cl1],
                            clients_moved=[int(participating[i]) for i in cl2],
                            alpha_cross=round(float(alpha_cross), 4),
                            gamma=self.cfl_gamma,
                            mean_norm=round(mean_norm, 6),
                            max_norm=round(max_norm, 6))

        if did_split and self.cfl_retrain == "all":
            for tt in range(t):
                self.weights[tt] = self.weights[t].copy()
        return did_split

    def _find_unused_model_capped(self) -> int:
        """The next never-used slot, or -1 once the pool is full."""
        if self.h_next_free < self.M:
            nxt = self.h_next_free
            self.h_next_free += 1
            return nxt
        return -1

    @staticmethod
    def _bipartition(S: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Complete-linkage bipartition on the cosine similarities S
        (d = 1 - S, a monotone transform of the reference's -S, gives the
        same 2-way cut)."""
        # clip: float error can push a cosine past 1.0, which would hand
        # scipy a negative distance
        d = 1.0 - np.clip(S, -1.0, 1.0)
        np.fill_diagonal(d, 0.0)
        d = (d + d.T) / 2.0     # numerical symmetry for squareform
        Z = sch.linkage(squareform(d, checks=False), method="complete")
        labels = sch.fcluster(Z, t=2, criterion="maxclust")
        cl1 = np.where(labels == labels[0])[0]
        cl2 = np.where(labels != labels[0])[0]
        return cl1, cl2

    # ------------------------------------------------------------------
    def _log_models(self, t: int) -> None:
        if not self.logger:
            return
        if self.h_cluster == "E":
            num_models = len(self._models_in_use_before(t))
            if self.h_marked:
                num_models += 1
        else:
            num_models = sum(1 for m in range(self.M)
                             if (self.weights[: t + 1, m, :] > 0).any())
        self.logger.set_summary("num_models", num_models)
        assign = self.test_model_idx(t)
        counts = np.bincount(assign, minlength=self.M)
        obs.registry().gauge("num_models").set(num_models)
        obs.emit("cluster_state", num_models=int(num_models),
                 spawns=self.event_counts["spawns"],
                 merges=self.event_counts["merges"],
                 model_clients={int(m): int(counts[m])
                                for m in np.nonzero(counts)[0]})
        self.emit_assignment(t)

        trained_by = {m: set(np.nonzero(self.weights[: t + 1, m, :].sum(0))[0])
                      for m in range(self.M)}
        local_models = sum(1 for m, cs in trained_by.items() if len(cs) == 1)
        self.logger.set_summary("local_models", local_models)
        shared = {m: cs for m, cs in trained_by.items() if len(cs) > 1}
        for c in range(self.C):
            self.logger.set_summary(
                f"Contribute/CL-{c}",
                sum(1 for cs in shared.values() if c in cs))

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "weights": self.weights,
            "mmacc_acc": self.mmacc_acc,
            "h_marked": dict(self.h_marked),
            "h_next_free": self.h_next_free,
            "cfl_norm": self.cfl_norm,
            "cfl_eps1": self.cfl_eps1,
            "cfl_eps2": self.cfl_eps2,
            # the rng state, so a resumed run replays the same LRU ties and
            # FedDrift-C keep-one choices as a continuous one
            "rng_state": self.rng.bit_generator.state,
        }

    def load_state_dict(self, d: dict) -> None:
        self.weights = np.asarray(d["weights"], dtype=np.float32)
        self.mmacc_acc = np.asarray(d["mmacc_acc"])
        self.h_marked = {int(k): tuple(v) for k, v in d["h_marked"].items()}
        self.h_next_free = int(d["h_next_free"])
        # a checkpoint written before CFL was ported has no CFL state: the
        # values a fresh run starts from
        self.cfl_norm = float(d.get("cfl_norm", 0.0))
        self.cfl_eps1 = float(d.get("cfl_eps1", 0.0))
        self.cfl_eps2 = float(d.get("cfl_eps2", 1e4))
        if "rng_state" in d:
            self.rng.bit_generator.state = d["rng_state"]
