"""Single-model continual baselines: oblivious windows and recency weighting.

Counterpart of ``feddrift_tpu/algorithms/singlemodel.py``: the paper's
single-model baselines (``win-N`` / ``all`` / ``oblivious`` through
``retrain_data``, and the ``exp`` / ``lin`` recency-weighted trainers). One
model (M = 1), every client on it, time weights ``[1, C, T1]`` that are a
function of t alone; every step runs on the fused path.
"""

from __future__ import annotations

import torch

from feddrift_torch.algorithms.base import DriftAlgorithm, register_algorithm
from feddrift_torch.data.retrain import is_retrain_spec, time_weights


class _TimeWeighted(DriftAlgorithm):
    """One model trained on the time weights of ``self.spec``."""

    spec = "win-1"

    def begin_iteration(self, t: int) -> None:
        w = time_weights(self.spec, self.C, t, self.T1)        # [C, T1]
        self._tw = torch.from_numpy(w[None]).to(self.step.device)

    def round_inputs(self, t: int, r: int):
        return self._tw, None, None, 1.0

    def chunkable(self, t: int) -> bool:
        return True


@register_algorithm("win-1", "all", "oblivious", "window")
class WindowBaseline(_TimeWeighted):
    """One model on a retrain window of past steps: ``cfg.retrain_data``
    ('win-N', 'all', 'weight-exp', ...), or the algorithm's own name for
    ``win-1`` / ``all``; ``oblivious`` is the drift-oblivious baseline, one
    model on all data (``all``), as in the reference. ``poisson*`` trains
    as win-1 with unit sample weights, as the reference's window does (the
    per-sample Poisson counts are KUE's)."""

    name = "window"

    def __init__(self, cfg, ds, pool, step) -> None:
        super().__init__(cfg, ds, pool, step)
        spec = cfg.retrain_data
        if cfg.concept_drift_algo in ("win-1", "all"):
            spec = cfg.concept_drift_algo
        elif cfg.concept_drift_algo == "oblivious":
            spec = "all"
        if not is_retrain_spec(spec, self.C, self.T1):
            raise ValueError(f"retrain_data {spec!r} is not a retrain spec "
                             f"for {self.C} clients and {self.T1} steps")
        self.spec = spec


@register_algorithm("exp", "lin")
class RecencyWeighted(_TimeWeighted):
    """Exponential (2^t) or linear (t + 1) recency sampling over all past
    steps."""

    name = "recency"

    def __init__(self, cfg, ds, pool, step) -> None:
        super().__init__(cfg, ds, pool, step)
        self.spec = "weight-exp" if cfg.concept_drift_algo == "exp" \
            else "weight-linear"
