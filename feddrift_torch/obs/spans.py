"""Trace contexts and span recording (the read path's subset).

Copy of the parts of ``feddrift_tpu/obs/spans.py`` that serving uses: the
W3C-style ``(trace_id, span_id, parent_span_id)`` context dicts and a
span recorder (in-memory ring plus optional JSONL file) that is disabled
until ``configure()`` arms it, so unconfigured processes pay one check.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import uuid
from typing import Any

RING_SIZE = 8192


def new_trace() -> dict:
    """Root context for a fresh causal chain."""
    return {"trace_id": uuid.uuid4().hex[:16],
            "span_id": uuid.uuid4().hex[:16]}


def child_of(ctx: dict | None) -> dict:
    """Continue a received context: same trace, new span, parent linked.
    A None/malformed context starts a new root (never raises)."""
    if not isinstance(ctx, dict) or "trace_id" not in ctx:
        return new_trace()
    out = {"trace_id": str(ctx["trace_id"]),
           "span_id": uuid.uuid4().hex[:16]}
    if ctx.get("span_id"):
        out["parent_span_id"] = str(ctx["span_id"])
    return out


class SpanRecorder:
    """Thread-safe span sink: in-memory ring + optional JSONL file."""

    def __init__(self, path: str | None = None, pid: int = 0,
                 enabled: bool = True) -> None:
        self._lock = threading.Lock()
        self.ring: collections.deque = collections.deque(maxlen=RING_SIZE)
        self.pid = pid
        self.enabled = enabled
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def record(self, name: str, ts: float, dur: float, cat: str = "phase",
               **args: Any) -> dict | None:
        """Record one completed span. ``ts`` unix seconds, ``dur`` seconds."""
        if not self.enabled:
            return None
        rec = {"name": name, "cat": cat,
               "ts": round(ts * 1e6, 1), "dur": round(dur * 1e6, 1),
               "pid": self.pid, "tid": threading.get_ident()}
        if args:
            rec["args"] = args
        with self._lock:
            self.ring.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()
        return rec

    def spans(self, name: str | None = None) -> list[dict]:
        with self._lock:
            out = list(self.ring)
        return out if name is None else [s for s in out if s["name"] == name]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_recorder = SpanRecorder(None, enabled=False)
_rec_lock = threading.Lock()


def get_recorder() -> SpanRecorder:
    return _recorder


def configure(path: str | None, pid: int = 0) -> SpanRecorder:
    """Install a fresh enabled recorder writing to ``path`` (None =
    memory-only)."""
    global _recorder
    with _rec_lock:
        old, _recorder = _recorder, SpanRecorder(path, pid=pid)
        old.close()
    return _recorder


def record(name: str, ts: float, dur: float, cat: str = "phase",
           **args: Any) -> dict | None:
    return _recorder.record(name, ts, dur, cat, **args)
