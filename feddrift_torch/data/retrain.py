"""Retrain-window specifications as dense time-weight tensors.

Counterpart of ``feddrift_tpu/data/retrain.py`` (numpy only; the port keeps
its own copy). The reference expresses "which past time steps feed a
model's training" as a string spec:

    all | win-N | weight-linear | weight-exp | sel-i,j,... |
    clientsel-<json per-client lists> | poisson

Here the spec becomes a ``[C, T_total]`` float weight matrix over time
steps. A weight of w on step t means samples of that step are drawn with
relative probability w during local SGD, which equals the reference's
duplicated-rows sampling because every step holds the same number of
samples. ``poisson`` is win-1 at the step level; its per-sample Poisson(1)
counts (KUE's bootstrap) come from ``poisson_sample_counts`` and reach
local SGD as per-sample weights through the weighted draw (K4).
"""

from __future__ import annotations

import json

import numpy as np

# Fallback horizon for grammar probing when the caller's true dimensions
# are unknown: far beyond any experiment's train_iterations.
_PROBE_STEPS = 4096


def is_retrain_spec(retrain_method: str, num_clients: int = 1,
                    total_steps: int = _PROBE_STEPS) -> bool:
    """True iff ``time_weights`` accepts the string. With the experiment's
    real ``num_clients`` / ``total_steps`` every step is probed, so
    ``sel-`` / ``clientsel-`` indices out of range are refused too; the
    defaults check the grammar only (one probe at t = 0)."""
    probe_ts = [0] if total_steps >= _PROBE_STEPS else range(total_steps)
    try:
        for t in probe_ts:
            time_weights(retrain_method, num_clients, t, total_steps)
    except Exception:   # noqa: BLE001 — any parse failure means "not a spec"
        return False
    return True


def time_weights(retrain_method: str, num_clients: int, current_iteration: int,
                 total_steps: int) -> np.ndarray:
    """Dense ``[C, total_steps]`` weights; zero for steps after
    ``current_iteration``."""
    t = current_iteration
    w = np.zeros((num_clients, total_steps), dtype=np.float32)
    if retrain_method == "all":
        w[:, : t + 1] = 1.0
    elif retrain_method.startswith("win-"):
        win = int(retrain_method.removeprefix("win-"))
        w[:, max(0, t - win + 1) : t + 1] = 1.0
    elif retrain_method.startswith("weight-"):
        kind = retrain_method.removeprefix("weight-")
        if kind not in ("linear", "exp"):
            raise NameError(retrain_method)
        for it in range(t + 1):
            w[:, it] = (it + 1) if kind == "linear" else float(2**it)
    elif retrain_method.startswith("sel-"):
        spec = retrain_method.removeprefix("sel-")
        if spec:
            for it in spec.split(","):
                w[:, int(it)] = 1.0
    elif retrain_method.startswith("clientsel-"):
        per_client = json.loads(retrain_method.removeprefix("clientsel-"))
        for c in range(num_clients):
            for it in per_client[c]:
                w[c, int(it)] = 1.0
    elif retrain_method.startswith("poisson"):
        w[:, t] = 1.0
    else:
        raise NameError(retrain_method)
    return w


def poisson_sample_counts(num_clients: int, sample_num: int,
                          rng: np.random.Generator) -> np.ndarray:
    """Per-sample Poisson(1) bootstrap counts ``[C, N]`` float32 (KUE),
    drawn from ``rng``. A client whose counts sum to zero gets ones (the
    reference's "if sum(weights) != 0" guard)."""
    counts = rng.poisson(1.0, size=(num_clients, sample_num)).astype(np.float32)
    counts[counts.sum(axis=1) == 0] = 1.0
    return counts
