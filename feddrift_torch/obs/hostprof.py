"""Host-plane observatory: sampling stack profiler + subsystem ledger.

Copy of ``feddrift_tpu/obs/hostprof.py`` (all but ``fit_scaling``, which
serves the reference's ``bench.py --hostscale``, not ported):

- ``SamplingProfiler`` — a daemon thread sampling every OTHER thread's
  stack via ``sys._current_frames()`` at ``cfg.hostprof_hz`` (default
  off). Aggregates folded stacks (flamegraph-ready ``a;b;c count``
  text, ``write_folded``) and writes leaf-change slices to
  ``<run_dir>/hostprof.jsonl`` in the span schema, which
  ``report --trace`` merges into the Perfetto timeline as its own lane.
- ``HostLedger`` — named-subsystem accounting (``SUBSYSTEMS``) of
  host-seconds per round plus host bytes of tracked structures and the
  process RSS watermark. ``finalize()`` emits one ``host_ledger`` event
  per iteration and sets the ``host_ledger_seconds{subsystem=}`` /
  ``host_bytes{structure=}`` instruments (plus
  ``host_ledger_seconds_total`` counters). The port's runner books its
  ``drift_decision`` and ``writeback`` segments here, as the reference's
  does (``writeback`` as ``registry_writeback``).

Stdlib only (RSS comes from /proc, falling back to getrusage); recording
is O(1) per call like obs/instruments.py.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Iterator, Optional

from feddrift_torch.obs.instruments import registry

# The closed subsystem set the reference's ledger accounts; the port's
# runner books drift_decision and registry_writeback so far.
SUBSYSTEMS = ("cohort_plan", "registry_writeback", "routing_rebuild",
              "stager", "broker_io", "drift_decision")


# ----------------------------------------------------------------------
# stdlib process-memory + nbytes helpers
def rss_bytes() -> Optional[int]:
    """Current resident set size in bytes: /proc/self/status VmRSS where
    available (Linux), ``getrusage`` peak otherwise; None when neither
    source works (observability stays passive, never raises)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:                  # noqa: BLE001 — best-effort probe
        return None


def nbytes_of(tree: Any) -> int:
    """Total bytes over every array-like leaf of a nested dict/list/tuple
    container: ``.nbytes`` of numpy arrays, ``numel() * element_size()``
    of torch tensors; non-array leaves contribute zero."""
    if isinstance(tree, dict):
        return sum(nbytes_of(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes_of(v) for v in tree)
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        return int(tree.numel()) * int(tree.element_size())
    nb = getattr(tree, "nbytes", None)
    try:
        return int(nb) if nb is not None else 0
    except (TypeError, ValueError):
        return 0


# ----------------------------------------------------------------------
# the per-subsystem cost/memory ledger
class HostLedger:
    """Thread-safe accumulator of host-seconds per subsystem and host
    bytes per structure, finalized once per iteration into a
    ``host_ledger`` event + gauges/counters.

    Seconds are per-round state (cleared by ``finalize``); bytes are
    sticky latest-value state (a routing table rebuilt at iteration 3
    still occupies memory at iteration 7); the RSS watermark is the max
    ever observed by ``finalize`` since ``reset``.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seconds: dict[str, float] = {}
        self._bytes: dict[str, int] = {}
        self._rss_peak = 0

    def reset(self) -> None:
        with self._lock:
            self._seconds.clear()
            self._bytes.clear()
            self._rss_peak = 0

    # -- accounting -----------------------------------------------------
    def add_seconds(self, subsystem: str, dt: float) -> None:
        if dt <= 0:
            return
        with self._lock:
            self._seconds[subsystem] = self._seconds.get(subsystem, 0.0) + dt

    @contextlib.contextmanager
    def timed(self, subsystem: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_seconds(subsystem, time.perf_counter() - t0)

    def set_bytes(self, structure: str, nbytes: int) -> None:
        with self._lock:
            self._bytes[structure] = int(nbytes)

    # -- views ----------------------------------------------------------
    def seconds(self) -> dict[str, float]:
        with self._lock:
            return dict(self._seconds)

    def bytes(self) -> dict[str, int]:
        with self._lock:
            return dict(self._bytes)

    def top_bytes(self, n: int = 3) -> list[tuple[str, int]]:
        """The ``n`` largest tracked structures, for /status."""
        with self._lock:
            items = sorted(self._bytes.items(), key=lambda kv: -kv[1])
        return items[:n]

    @property
    def rss_peak_bytes(self) -> int:
        with self._lock:
            return self._rss_peak

    # -- per-iteration finalize -----------------------------------------
    def finalize(self, iteration: Optional[int] = None, rounds: int = 1,
                 emit_event: bool = True) -> dict:
        """Snapshot + clear this round's seconds, refresh the
        instruments, and emit the per-iteration ``host_ledger`` event.
        Returns the event fields (tests and callers without a bus)."""
        with self._lock:
            sec = dict(self._seconds)
            self._seconds.clear()
            byt = dict(self._bytes)
        rss = rss_bytes()
        if rss is not None:
            with self._lock:
                self._rss_peak = max(self._rss_peak, rss)
                peak = self._rss_peak
        else:
            peak = self.rss_peak_bytes
        reg = registry()
        for name, s in sec.items():
            reg.gauge("host_ledger_seconds", subsystem=name).set(round(s, 6))
            reg.counter("host_ledger_seconds_total", subsystem=name).inc(s)
        for name, b in byt.items():
            reg.gauge("host_bytes", structure=name).set(b)
        if rss is not None:
            reg.gauge("host_rss_bytes").set(rss)
            reg.gauge("host_rss_peak_bytes").set(peak)
        rec = {
            "iteration": iteration, "rounds": int(rounds),
            "seconds": {k: round(v, 6) for k, v in sorted(sec.items())},
            "bytes": {k: int(v) for k, v in sorted(byt.items())},
            "rss_bytes": rss,
            "rss_peak_bytes": peak or None,
        }
        if emit_event:
            from feddrift_torch.obs import events as _events
            try:
                _events.emit("host_ledger", **rec)
            except Exception:   # noqa: BLE001 — observability stays passive
                pass
        return rec


_ledger = HostLedger()


def ledger() -> HostLedger:
    """The process-local ledger every instrumented layer reports into
    (mirrors ``obs.registry()`` / ``obs.live.status_board()``)."""
    return _ledger


# ----------------------------------------------------------------------
# the sampling stack profiler
class SamplingProfiler:
    """Low-overhead wall-clock sampler over ``sys._current_frames()``.

    A daemon thread wakes every ``1/hz`` seconds and folds each OTHER
    thread's current stack into an aggregate ``{(frame, ...): count}``
    map. Consecutive samples sharing a leaf frame coalesce into one
    timeline *slice* written to ``path`` (span schema, lane
    ``hostprof:<tid>``) so ``report --trace`` shows where host threads
    actually spent their time between the instrumented spans.

    ``start``/``stop``/``close`` are idempotent and thread-safe; a
    sampling error never propagates (the profiled run must not care).
    """

    def __init__(self, hz: float, path: Optional[str] = None, pid: int = 0,
                 max_stack: int = 48) -> None:
        if hz <= 0:
            raise ValueError(f"hz must be > 0, got {hz}")
        self.hz = float(hz)
        self.period = 1.0 / self.hz
        self.path = path
        self.pid = pid
        self.max_stack = int(max_stack)
        self.samples = 0
        self._lock = threading.Lock()
        self._folded: dict[tuple, int] = {}
        # tid -> [leaf, folded-stack-str, t_start, t_last] of the open slice
        self._open: dict[int, list] = {}
        # code object -> "file.py:fn" label; memoized because formatting
        # every frame of every thread at 50 Hz is the sampler's hot cost
        self._labels: dict = {}
        # tid -> ((leaf frame id, f_lasti), stack tuple): threads parked
        # in a wait keep the same leaf frame at the same instruction, so
        # their stacks are reused without re-walking — on a 1-core host
        # most threads are parked at every sample
        self._last: dict[int, tuple] = {}
        # closed slices buffer: written in one batch at stop() — a 1-core
        # host cannot afford a write+flush per leaf change
        self._slices: list[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fh = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "SamplingProfiler":
        with self._lock:
            if self._thread is not None:
                return self                      # already running
            if self.path and self._fh is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._fh = open(self.path, "a")
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="hostprof-sampler")
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
            self._stop.set()
        if thread is not None:
            thread.join(timeout=2.0)
        with self._lock:
            for tid, sl in self._open.items():
                self._close_slice_locked(tid, sl)
            self._open.clear()
            if self._fh is not None:
                for rec in self._slices:
                    self._fh.write(json.dumps(rec) + "\n")
                self._fh.close()
                self._fh = None
            self._slices = []

    close = stop

    def __enter__(self) -> "SamplingProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None

    # -- sampling -------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._sample_once(time.time())
            except Exception:   # noqa: BLE001 — sampling must never kill a run
                pass
            self._stop.wait(self.period)

    def _stack_of(self, frame) -> tuple:
        labels = self._labels
        out = []
        depth = 0
        while frame is not None and depth < self.max_stack:
            code = frame.f_code
            lbl = labels.get(code)
            if lbl is None:
                lbl = f"{os.path.basename(code.co_filename)}:{code.co_name}"
                labels[code] = lbl
            out.append(lbl)
            frame = frame.f_back
            depth += 1
        out.reverse()                            # root;...;leaf folded order
        return tuple(out)

    def _sample_once(self, now: float) -> None:
        me = threading.get_ident()
        frames = sys._current_frames()
        last = self._last
        with self._lock:
            self.samples += 1
            for tid, frame in frames.items():
                if tid == me:
                    continue
                key = (id(frame), frame.f_lasti)
                cached = last.get(tid)
                if cached is not None and cached[0] == key:
                    stack = cached[1]            # parked thread: no walk
                else:
                    stack = self._stack_of(frame)
                    last[tid] = (key, stack)
                if not stack:
                    continue
                self._folded[stack] = self._folded.get(stack, 0) + 1
                self._fold_slice_locked(tid, stack, now)

    def _fold_slice_locked(self, tid: int, stack: tuple, now: float) -> None:
        leaf = stack[-1]
        sl = self._open.get(tid)
        if sl is not None and sl[0] == leaf:
            sl[3] = now                          # extend the open slice
            return
        if sl is not None:
            self._close_slice_locked(tid, sl)
        self._open[tid] = [leaf, stack[-12:], now, now]

    def _close_slice_locked(self, tid: int, sl: list) -> None:
        if self._fh is None:
            return
        leaf, stack, t0, t1 = sl
        # a single-sample slice still renders one sampling period wide
        dur = max(t1 - t0, self.period)
        self._slices.append(
            {"name": leaf, "cat": "hostprof",
             "ts": round(t0 * 1e6, 1), "dur": round(dur * 1e6, 1),
             "pid": self.pid, "tid": f"hostprof:{tid}",
             "args": {"stack": ";".join(stack)}})

    # -- export ---------------------------------------------------------
    def folded(self) -> dict[str, int]:
        """{"root;...;leaf": samples} aggregate."""
        with self._lock:
            return {";".join(s): c for s, c in self._folded.items()}

    def folded_text(self) -> str:
        """Flamegraph-ready folded-stack text, hottest stacks first."""
        items = sorted(self.folded().items(), key=lambda kv: (-kv[1], kv[0]))
        return "\n".join(f"{stack} {count}" for stack, count in items) \
            + ("\n" if items else "")

    def write_folded(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.folded_text())
        return path


# Process-wide active sampler: constructing an Experiment re-points it
# (and stops the previous one), so back-to-back runs in one process
# never leak sampler threads.
_profiler: Optional[SamplingProfiler] = None
_prof_lock = threading.Lock()


def configure_profiler(hz: float, path: Optional[str] = None,
                       pid: int = 0) -> Optional[SamplingProfiler]:
    """Install (hz > 0) or clear (hz <= 0) the process-wide sampler,
    stopping any previous one first. Returns the active sampler."""
    global _profiler
    with _prof_lock:
        old, _profiler = _profiler, None
    if old is not None:
        old.stop()
    if hz > 0:
        prof = SamplingProfiler(hz, path=path, pid=pid).start()
        with _prof_lock:
            _profiler = prof
        return prof
    return None


def get_profiler() -> Optional[SamplingProfiler]:
    with _prof_lock:
        return _profiler
