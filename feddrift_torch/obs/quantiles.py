"""Streaming quantile sketches (P² algorithm), O(1) memory per quantile.

Copy of ``feddrift_tpu/obs/quantiles.py``. The P² algorithm (Jain &
Chlamtac, CACM 1985) maintains five markers per tracked quantile and
adjusts them with a piecewise-parabolic update on every observation —
constant memory, constant time, no sorting. ``QuantileSketch`` is the
registrable instrument (``Registry.quantile_sketch``): a tuple of
quantiles (default p50/p95/p99) plus count/sum/min/max.
"""

from __future__ import annotations

import math
import threading

DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


class P2Estimator:
    """Single-quantile P² estimator: five markers, no sample retention.

    The first five observations are stored exactly; from the sixth on,
    marker heights are nudged toward their desired positions with the
    parabolic (fallback linear) interpolation from the paper.
    """

    __slots__ = ("p", "n", "_init", "q", "npos", "dn")

    def __init__(self, p: float) -> None:
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = float(p)
        self.n = 0
        self._init: list[float] | None = []
        self.q: list[float] | None = None      # marker heights
        self.npos: list[int] | None = None     # marker positions (1-based)
        self.dn = (0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0)

    def observe(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.q is None:
            self._init.append(x)
            if len(self._init) == 5:
                self._init.sort()
                self.q = list(self._init)
                self.npos = [1, 2, 3, 4, 5]
                self._init = None
            return
        q, npos = self.q, self.npos
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            npos[i] += 1
        for i in (1, 2, 3):
            desired = 1.0 + (self.n - 1) * self.dn[i]
            d = desired - npos[i]
            if (d >= 1.0 and npos[i + 1] - npos[i] > 1) or \
                    (d <= -1.0 and npos[i - 1] - npos[i] < -1):
                step = 1 if d >= 0 else -1
                qn = self._parabolic(i, step)
                if not (q[i - 1] < qn < q[i + 1]):
                    qn = self._linear(i, step)
                q[i] = qn
                npos[i] += step

    def _parabolic(self, i: int, d: int) -> float:
        q, npos = self.q, self.npos
        return q[i] + d / (npos[i + 1] - npos[i - 1]) * (
            (npos[i] - npos[i - 1] + d) * (q[i + 1] - q[i])
            / (npos[i + 1] - npos[i])
            + (npos[i + 1] - npos[i] - d) * (q[i] - q[i - 1])
            / (npos[i] - npos[i - 1]))

    def _linear(self, i: int, d: int) -> float:
        q, npos = self.q, self.npos
        return q[i] + d * (q[i + d] - q[i]) / (npos[i + d] - npos[i])

    def quantile(self) -> float | None:
        """Current estimate; exact (nearest-rank) below five samples,
        None before the first observation."""
        if self.q is not None:
            return self.q[2]
        if not self._init:
            return None
        s = sorted(self._init)
        idx = min(len(s) - 1, max(0, math.ceil(self.p * len(s)) - 1))
        return s[idx]


class QuantileSketch:
    """Multi-quantile streaming sketch, instrument-shaped (thread-safe
    observe, locked snapshot) so it registers alongside Counter."""

    __slots__ = ("_lock", "quantiles", "_est", "count", "sum",
                 "min", "max")

    def __init__(self, quantiles: tuple = DEFAULT_QUANTILES) -> None:
        self._lock = threading.Lock()
        self.quantiles = tuple(float(q) for q in quantiles)
        if not self.quantiles:
            raise ValueError("at least one quantile is required")
        self._est = {q: P2Estimator(q) for q in self.quantiles}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            for est in self._est.values():
                est.observe(v)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "quantiles": {f"{q:g}": est.quantile()
                              for q, est in self._est.items()},
            }
