"""Tracing & profiling: per-phase wall clock and the device profiler.

Copy of ``feddrift_tpu/utils/tracing.py`` with the device trace on
``torch.profiler``:

    tracer = PhaseTracer()
    with tracer.phase("cluster"):
        ...
    with tracer.phase("train_round"):
        ...
    tracer.summary()  # {"cluster": {"total_s": ..., "count": ...}, ...}

    with device_trace("/tmp/trace"):   # Chrome-trace JSON of host + kernels
        run_step()

PhaseTracer is thread-safe and nestable/re-entrant: each ``phase()`` entry
keeps its own start time on the context-manager frame, so overlapping
phases on one thread and concurrent phases across threads both accumulate
correctly. Pass ``registry=obs.registry()`` to additionally record each
phase duration into a ``phase_seconds{phase=...}`` histogram, and
``spans=obs.spans.get_recorder()`` to put every phase on the trace
timeline (``report <run_dir> --trace``).

``device_trace`` is no-op-safe under nesting, as the reference's
``xla_trace``: an inner ``device_trace`` runs its body without starting
(or stopping) anything, and each completed capture writes a
``<host>.<pid>.pt.trace.json`` (CPU and, on a card, CUDA activities: the
kernels by name) into its directory and emits a ``profile_captured``
event carrying the directory.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import threading
from collections import defaultdict
from typing import Iterator

from feddrift_torch.obs.spans import SpanRecorder

log = logging.getLogger("feddrift_torch")


class PhaseTracer:
    """Accumulates wall-clock per named phase; nestable, re-entrant, and
    thread-safe.

    The interval measurement itself lives in ``obs.spans.SpanRecorder``:
    ``phase()`` is a thin shim over ``SpanRecorder.span(..., on_close=...)``
    that hangs the total/count accounting and the ``phase_seconds``
    histogram off the span's completion hook. Without an explicit
    ``spans=`` recorder a private memory-only recorder measures.
    """

    def __init__(self, registry=None, spans=None) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._registry = registry
        self._spans = spans if spans is not None \
            else SpanRecorder(None, enabled=False)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        def account(_wall0: float, dt: float) -> None:
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
            if self._registry is not None:
                self._registry.histogram("phase_seconds",
                                         phase=name).observe(dt)

        with self._spans.span(name, cat="phase", on_close=account):
            yield

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {name: {"total_s": self.totals[name],
                           "count": self.counts[name],
                           "mean_s": self.totals[name] / max(self.counts[name], 1)}
                    for name in self.totals}

    def log_summary(self, prefix: str = "") -> None:
        for name, s in sorted(self.summary().items()):
            log.info("%sphase %-16s total=%.3fs mean=%.4fs n=%d",
                     prefix, name, s["total_s"], s["mean_s"], s["count"])

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()


# True while a device_trace capture is active in this process: a nested
# entry is a clean no-op (body runs, the outer capture owns the trace).
_trace_active = False
_trace_lock = threading.Lock()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """``torch.profiler`` trace of the body, CPU activities and, where a
    card is visible, CUDA ones. No-op-safe: if a trace is already active
    (nested use) or the profiler cannot start, the body still runs and the
    outer capture is left untouched. Each completed capture writes its
    Chrome-trace JSON into ``log_dir`` and emits ``profile_captured``."""
    global _trace_active
    import torch
    prof = None
    with _trace_lock:
        nested = _trace_active
        if not nested:
            _trace_active = True
    if nested:
        log.debug("device_trace: trace already active; nested capture of "
                  "%s is a no-op", log_dir)
    else:
        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as e:                  # pragma: no cover
            log.warning("device_trace: profiler unavailable (%s)", e)
            prof = None
            with _trace_lock:
                _trace_active = False
    try:
        yield
    finally:
        if prof is not None:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()    # the body's kernels ended
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"{socket.gethostname()}.{os.getpid()}"
                             f".pt.trace.json"))
                from feddrift_torch import obs
                obs.emit("profile_captured", trace_dir=log_dir)
            finally:
                with _trace_lock:
                    _trace_active = False


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (a ``record_function`` range)."""
    import torch
    with torch.profiler.record_function(name):
        yield
