"""Per-round numeric divergence guard: detect, roll back, bound.

A copy of ``feddrift_tpu/resilience/divergence.py`` (the guard is host
numpy; the port's runner fetches the losses it reads).

Partial participation plus aggressive local LR can blow a model pool up —
NaN/Inf parameters, or a loss spike that takes many rounds to re-descend.
The reference has no detection at all; a NaN simply propagates into every
metric. The guard watches the *fetched* per-round mean losses (the
``losses [M, C]`` output of ``TrainStep``; inactive (m, c) pairs are
excluded via ``n``), and flags a round as diverged when

- any participating cell is non-finite, or
- the participating-cell mean exceeds ``spike_factor`` times the PEAK
  round mean seen so far in the window (armed only after ``warmup``
  rounds). The reference is a high-water mark, not a running average,
  deliberately: under client subsampling each round trains a different
  subset, and heterogeneous/freshly-drifted subsets legitimately sit an
  order of magnitude above the converged rounds — a mean/EMA baseline
  flags that healthy variance, while a true numeric blow-up grows
  exponentially past any level the window has ever produced.

The spike baseline is WINDOWED PER TIME STEP (``new_window()``, called by
the runner at every iteration start): drift workloads legitimately
re-spike the loss at every time-step boundary — the concept changed and
the window retrains — and a cross-iteration baseline would flag exactly
that healthy re-learning as divergence. Within a window the spike test
arms after ``warmup`` healthy rounds; non-finite detection is always
armed. Consequence for the fused execution path (one check per time
step, on the final round's losses): the guard there catches non-finite
blow-ups — NaN/Inf sticks to the params, so the last round sees it —
while spike detection is a per-round-path feature.

On a diverged round the runner rolls the pool back to the pre-round
params (and re-initializes optimizer state, which the diverged step also
contaminated), emits ``divergence_detected``, and skips the round's eval.
``max_rollbacks`` CONSECUTIVE rollbacks raise ``DivergenceError`` —
a run that cannot make progress should die loudly, not burn an
accelerator reservation re-diverging forever.
"""

from __future__ import annotations

import numpy as np


class DivergenceError(RuntimeError):
    """Raised after ``max_rollbacks`` consecutive diverged rounds."""


class DivergenceGuard:
    def __init__(self, spike_factor: float = 10.0, max_rollbacks: int = 3,
                 warmup: int = 5) -> None:
        if spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1")
        if max_rollbacks < 1:
            raise ValueError("max_rollbacks must be >= 1")
        self.spike_factor = spike_factor
        self.max_rollbacks = max_rollbacks
        self.warmup = warmup
        self.baseline: float | None = None   # window PEAK round mean
        self.healthy_rounds = 0
        self.consecutive_rollbacks = 0
        self.total_rollbacks = 0

    def new_window(self) -> None:
        """Start a fresh baseline window (a new time step): the data/concept
        changed, so the old loss level is no longer the reference. The
        consecutive-rollback count is NOT reset — a run re-diverging across
        a boundary is still a run that cannot make progress."""
        self.baseline = None
        self.healthy_rounds = 0

    def check(self, losses, n) -> "tuple[bool, str, float]":
        """(diverged, reason, observed) for one round's host-side arrays.

        ``losses``/``n`` are the [M, C] per-(model, client) mean losses and
        weighted sample counts; cells with n == 0 never trained this round
        (masked / phantom / non-sampled) and are ignored.
        """
        losses = np.asarray(losses, dtype=np.float64)
        mask = np.asarray(n, dtype=np.float64) > 0
        vals = losses[mask]
        if vals.size == 0:
            return False, "", 0.0
        if not np.isfinite(vals).all():
            return True, "nonfinite", float("nan")
        mean = float(vals.mean())
        if (self.healthy_rounds >= self.warmup and self.baseline is not None
                and mean > self.spike_factor * self.baseline):
            return True, "loss_spike", mean
        # healthy: the window high-water mark absorbs this round's level
        self.baseline = (mean if self.baseline is None
                         else max(self.baseline, mean))
        self.healthy_rounds += 1
        self.consecutive_rollbacks = 0
        return False, "", mean

    def record_rollback(self) -> None:
        """Count one rollback; raise once the consecutive budget is spent."""
        self.consecutive_rollbacks += 1
        self.total_rollbacks += 1
        if self.consecutive_rollbacks >= self.max_rollbacks:
            raise DivergenceError(
                f"{self.consecutive_rollbacks} consecutive diverged rounds "
                f"(baseline={self.baseline}); aborting the run")
