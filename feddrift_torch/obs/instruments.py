"""Counters, gauges, histograms and quantile sketches in a process-local
registry.

The subset of ``feddrift_tpu/obs/instruments.py`` the ported layers
touch. A time series is keyed by (name, sorted label pairs); get-or-
create accessors are idempotent and type-checked; every instrument
records under its own lock. Histograms use fixed cumulative buckets
(Prometheus ``le`` semantics): recording is two integer increments and a
float add, never sample retention.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any

from feddrift_torch.obs.quantiles import DEFAULT_QUANTILES, QuantileSketch

DEFAULT_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   100.0)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += n


class Gauge:
    """A value that goes up and down."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` semantics on export)."""

    __slots__ = ("_lock", "bounds", "bucket_counts", "count", "sum")

    def __init__(self, buckets: tuple = DEFAULT_BUCKETS) -> None:
        self._lock = threading.Lock()
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.bucket_counts[idx] += 1
            self.count += 1
            self.sum += v

    def reset(self) -> None:
        """Drop every series."""
        with self._lock:
            self._series.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "buckets": {("+Inf" if i == len(self.bounds)
                                 else repr(self.bounds[i])): c
                                for i, c in enumerate(self.bucket_counts)
                                if c}}


class Registry:
    """Process-local instrument registry, one series per (name, labels)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: dict[tuple, Any] = {}

    def _get(self, cls, name: str, labels: dict[str, str], **kw):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            inst = self._series.get(key)
            if inst is None:
                inst = self._series[key] = cls(**kw)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"instrument {name}{labels} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets: tuple = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def quantile_sketch(self, name: str,
                        quantiles: tuple = DEFAULT_QUANTILES,
                        **labels: str) -> QuantileSketch:
        return self._get(QuantileSketch, name, labels, quantiles=quantiles)

    def reset(self) -> None:
        """Drop every series."""
        with self._lock:
            self._series.clear()

    def snapshot(self) -> dict:
        """{"name{label=...}": value-or-sketch-dict}, JSON-ready."""
        with self._lock:
            items = sorted(self._series.items())
        out: dict[str, Any] = {}
        for (name, labels), inst in items:
            key = name + ("{" + ",".join(f'{k}="{v}"' for k, v in labels)
                          + "}" if labels else "")
            if isinstance(inst, (Histogram, QuantileSketch)):
                out[key] = inst.snapshot()
            else:
                with inst._lock:
                    out[key] = inst.value
        return out


_registry = Registry()


def registry() -> Registry:
    return _registry
