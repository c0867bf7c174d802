"""Process-local structured event bus (the ported layers' subset).

Copy of the core of ``feddrift_tpu/obs/events.py``: one event is a dict
with ``_ts``, a ``kind`` from a closed set and the ambient context
(``set_context(iteration=..., round=...)``), appended to a bounded
in-memory ring and, once ``configure(path)`` gave it a file, to a JSONL
sink. Unknown kinds raise. Only the kinds the ported layers emit are in
the set; they keep the reference's names and fields.
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
})

RING_SIZE = 4096


class EventBus:
    def __init__(self, path: str | None = None) -> None:
        self._lock = threading.Lock()
        self.ring: collections.deque = collections.deque(maxlen=RING_SIZE)
        self._fh = None
        self._context: dict[str, Any] = {}
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def emit(self, kind: str, **fields: Any) -> dict:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        rec = {"_ts": time.time(), "kind": kind, **self._context, **fields}
        with self._lock:
            self.ring.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec, default=str) + "\n")
                self._fh.flush()
        return rec

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


_bus = EventBus(None)
_bus_lock = threading.Lock()


def get_bus() -> EventBus:
    return _bus


def configure(path: str | None) -> EventBus:
    """Install a fresh default bus writing to ``path`` (None = memory-only)."""
    global _bus
    with _bus_lock:
        old, _bus = _bus, EventBus(path)
        old.close()
    return _bus


def emit(kind: str, **fields: Any) -> dict:
    return _bus.emit(kind, **fields)
