"""FedDrift's hierarchical clustering: the ``softcluster`` algorithm with an
``H_*`` argument.

Counterpart of ``feddrift_tpu/algorithms/softcluster.py::SoftCluster``
restricted to the ``hierarchical`` kind (``H_{distance}_{cluster}_{W}_
{100 delta}_{100 delta'}``), the main path's algorithm. The time-indexed
weights are a dense ``[T1, M, C]`` numpy tensor; accuracy matrices and cells
come from the device (``TrainStep.acc_matrix``/``acc_cells``); the
decisions (drift detection, LRU model slots, the hierarchical merge through
scipy's linkage) stay host-side numpy on O(M^2) matrices, as in the
reference. The same seed and the same accuracy inputs give the same
weights, merges, spawns, LRU picks and events. The other kinds (mmacc,
hard, softmax, gmm, geni, cfl) and the ``softclusterwin-1`` /
``softclusterreset`` variants raise ``NotImplementedError`` (ROADMAP
item 6).
"""

from __future__ import annotations

import numpy as np
import scipy.cluster.hierarchy as sch
import torch
from scipy.spatial.distance import squareform

from feddrift_torch import obs
from feddrift_torch.algorithms.base import DriftAlgorithm, register_algorithm


@register_algorithm("softcluster", "softclusterwin-1", "softclusterreset")
class SoftCluster(DriftAlgorithm):
    name = "softcluster"

    def __init__(self, cfg, ds, pool, step) -> None:
        super().__init__(cfg, ds, pool, step)
        p = cfg.algo_params()
        self.kind = p["kind"]
        self.p = p
        if cfg.concept_drift_algo != "softcluster" \
                or self.kind != "hierarchical":
            raise NotImplementedError(
                f"{cfg.concept_drift_algo!r} with {cfg.concept_drift_algo_arg!r}"
                f" (kind {self.kind!r}): the port has FedDrift's H_* "
                f"hierarchical softcluster only (ROADMAP item 6)")
        # dense [T1, M, C] replaces the reference's {t -> M x C} dict
        self.weights = np.zeros((self.T1, self.M, self.C), dtype=np.float32)
        self.mmacc_acc = np.zeros(self.C)           # per-client last best acc
        self.h_delta = p["h_delta"]
        self.h_deltap = p["h_deltap"]
        self.h_w = p["h_w"]
        self.h_distance = p["h_distance"]
        self.h_cluster = p["h_cluster"]
        self.h_marked: dict[int, tuple[int, int]] = {}   # client -> (model, unmark t)
        self.h_next_free = 1
        self.rng = np.random.default_rng(cfg.seed + 1009)
        self.event_counts = {"spawns": 0, "merges": 0, "linkage_calls": 0}
        self._tw = None

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
        return True

    def test_model_idx(self, t: int) -> np.ndarray:
        return np.argmax(self.weights[t], axis=0)

    # ------------------------------------------------------------------
    def begin_iteration(self, t: int) -> None:
        if t == 0:
            self._cluster_init()
            # arm the drift detector with the initial accuracies
            acc = self.acc_matrix_at(0)
            idx = self.test_model_idx(0)
            for c in range(self.C):
                self.mmacc_acc[c] = acc[idx[c], c]
        else:
            self._cluster_hierarchical(t)
        self._log_models(t)
        self._sync_device_weights()

    def after_round(self, t: int, r: int, prev_params, agg_params,
                    client_params, n):
        self.pool.params = agg_params
        return self.pool.params

    def _cluster_init(self) -> None:
        """Everyone on model 0, or one model per client for FedDrift-F."""
        self.weights[0] = 0.0
        if self.h_cluster == "F":
            if self.M < self.C:
                raise ValueError(
                    f"h_cluster='F' needs concept_num >= clients "
                    f"({self.M} < {self.C})")
            for c in range(self.C):
                self.weights[0, c, c] = 1.0
            self.h_next_free = self.C
        else:
            self.weights[0, 0, :] = 1.0

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
            # the rng state, so a resumed run replays the same LRU ties and
            # FedDrift-C keep-one choices as a continuous one
            "rng_state": self.rng.bit_generator.state,
        }

    def load_state_dict(self, d: dict) -> None:
        self.weights = np.asarray(d["weights"], dtype=np.float32)
        self.mmacc_acc = np.asarray(d["mmacc_acc"])
        self.h_marked = {int(k): tuple(v) for k, v in d["h_marked"].items()}
        self.h_next_free = int(d["h_next_free"])
        if "rng_state" in d:
            self.rng.bit_generator.state = d["rng_state"]
