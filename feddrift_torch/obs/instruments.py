"""Counters, gauges and quantile sketches in a process-local registry.

The subset of ``feddrift_tpu/obs/instruments.py`` the serving read path
touches. A time series is keyed by (name, sorted label pairs); get-or-
create accessors are idempotent and type-checked; every instrument
records under its own lock.
"""

from __future__ import annotations

import threading
from typing import Any

from feddrift_torch.obs.quantiles import DEFAULT_QUANTILES, QuantileSketch


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

    def quantile_sketch(self, name: str,
                        quantiles: tuple = DEFAULT_QUANTILES,
                        **labels: str) -> QuantileSketch:
        return self._get(QuantileSketch, name, labels, quantiles=quantiles)

    def snapshot(self) -> dict:
        """{"name{label=...}": value-or-sketch-dict}, JSON-ready."""
        with self._lock:
            items = sorted(self._series.items())
        out: dict[str, Any] = {}
        for (name, labels), inst in items:
            key = name + ("{" + ",".join(f'{k}="{v}"' for k, v in labels)
                          + "}" if labels else "")
            if isinstance(inst, QuantileSketch):
                out[key] = inst.snapshot()
            else:
                with inst._lock:
                    out[key] = inst.value
        return out


_registry = Registry()


def registry() -> Registry:
    return _registry
