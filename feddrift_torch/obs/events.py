"""Process-local structured event bus (the ported layers' subset).

Copy of the core of ``feddrift_tpu/obs/events.py``: one event is a dict
with ``_ts``, a ``kind`` from a closed set and the ambient context
(``set_context(iteration=..., round=...)``), appended to a bounded
in-memory ring and, once ``configure(path)`` gave it a file, to a JSONL
sink. Unknown kinds raise. Only the kinds the ported layers emit are in
the set; they keep the reference's names and fields. Taps (``add_tap``:
the alert monitor, the flight recorder, the incident manager) see every
record after the bus lock is released; a failing tap never raises into the
emitter. ``max_bytes`` size-caps the sink: a write past the cap rotates
the file to ``<path>.1`` (one generation kept) with an ``obs_rotated``
event in the fresh file.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any

EVENT_KINDS = frozenset({
    "request_served",       # one inference request answered
    "pool_swapped",         # engine published a new pool/routing generation
    "routing_rebuilt",      # a routing table was installed by a swap
    "replica_failed",       # the engine's dispatcher died mid-batch
    "run_start",            # Experiment built: dataset/model/algo/geometry
    "run_end",              # Experiment.run finished
    "iteration_start",      # a time step begins
    "iteration_end",        # a time step ends: wall, rounds/s, Test/Acc
    "round_breakdown",      # a time step's wall split into segments
    "eval",                 # one logged eval point
    "checkpoint_save",      # a checkpoint generation was written
    "checkpoint_corrupt",   # a generation failed verification; fell back
    "drift_detected",       # a client's accuracy dropped past delta
    "cluster_create",       # a model slot was (re)allocated for a client
    "cluster_merge",        # two clusters merged (FedDrift linkage)
    "cluster_delete",       # a model slot was cleared
    "cluster_split",        # CFL gradient bipartition fired
    "cluster_state",        # per-iteration cluster count summary
    "cluster_assign",       # per-iteration client -> model vector
    "model_replaced",       # ensemble rotation (AUE window, KUE worst model)
    "divergence_detected",  # NaN/Inf or loss spike -> params rolled back
    "preempt_checkpoint",   # SIGTERM/SIGINT -> checkpointed at a boundary
    "alert_raised",         # a run-health rule fired (obs/alerts.py)
    "incident_captured",    # a trigger debounced into an incident bundle
    "flight_dump",          # flight-recorder rings serialized into a bundle
    "obs_rotated",          # a size-capped JSONL sink rotated a generation
    "host_ledger",          # per-iteration host-seconds/bytes ledger + RSS
    "hbm_watermark",        # live torch.cuda.memory_stats() snapshot
    "profile_captured",     # a torch.profiler trace was written (device_trace)
})

RING_SIZE = 4096


class EventBus:
    def __init__(self, path: str | None = None, max_bytes: int = 0) -> None:
        self._lock = threading.Lock()
        self.ring: collections.deque = collections.deque(maxlen=RING_SIZE)
        self._fh = None
        self._context: dict[str, Any] = {}
        self._taps: list = []
        self.path = path
        self.max_bytes = int(max_bytes)
        self.rotations = 0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def emit(self, kind: str, **fields: Any) -> dict:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        rotated_bytes = 0
        with self._lock:
            rec = {"_ts": time.time(), "kind": kind, **self._context,
                   **fields}
            self.ring.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec, default=_json_default) + "\n")
                self._fh.flush()
                if self.max_bytes and self._fh.tell() >= self.max_bytes:
                    rotated_bytes = self._rotate_locked()
            taps = tuple(self._taps)
        if rotated_bytes:
            # after the lock is released; the fresh file is far below the
            # cap, so this cannot recurse
            self.emit("obs_rotated", file=os.path.basename(self.path),
                      rotated_bytes=rotated_bytes, generation=self.rotations)
        for tap in taps:
            try:
                tap(rec)
            except Exception:   # noqa: BLE001 — observability stays passive
                pass
        return rec

    def _rotate_locked(self) -> int:
        """Swap the sink to a fresh file (caller holds the lock); returns
        the size of the rotated-out generation."""
        size = self._fh.tell()
        self._fh.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self._fh = open(self.path, "a")
        self.rotations += 1
        return size

    def add_tap(self, fn) -> None:
        """Register a callable observing every emitted record (called on
        the emitting thread, after the record is persisted)."""
        with self._lock:
            self._taps.append(fn)

    def remove_tap(self, fn) -> None:
        with self._lock:
            if fn in self._taps:
                self._taps.remove(fn)

    def set_context(self, **ctx: Any) -> None:
        """Merge ambient fields (iteration=..., round=...) into every
        subsequent event; a value of None removes the key."""
        with self._lock:
            for k, v in ctx.items():
                if v is None:
                    self._context.pop(k, None)
                else:
                    self._context[k] = v

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self.ring)
        return evs if kind is None else [e for e in evs if e["kind"] == kind]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "EventBus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _json_default(o):
    """numpy scalars and arrays in event fields: store plain JSON."""
    tolist = getattr(o, "tolist", None)
    return tolist() if tolist is not None else str(o)


_bus = EventBus(None)
_bus_lock = threading.Lock()


def get_bus() -> EventBus:
    return _bus


def configure(path: str | None, max_bytes: int = 0) -> EventBus:
    """Install a fresh default bus writing to ``path`` (None = memory-only)."""
    global _bus
    with _bus_lock:
        old, _bus = _bus, EventBus(path, max_bytes=max_bytes)
        old.close()
    return _bus


def emit(kind: str, **fields: Any) -> dict:
    return _bus.emit(kind, **fields)
