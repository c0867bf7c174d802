"""Unified trace timeline: spans + events -> one Chrome-trace JSON.

Copy of ``feddrift_tpu/obs/spans.py``. A *span* is a named wall-clock
interval (phase, iteration, a round's device wait, a served request)
recorded live; an *event* (obs/events.py) is a point occurrence. This
module records the former to ``<run_dir>/spans.jsonl`` and folds BOTH,
with the sampling profiler's ``hostprof.jsonl``, into a single
Chrome-trace-event JSON that Perfetto / ``chrome://tracing`` loads:

    python -m feddrift_torch report <run_dir> --trace   # writes trace.json

Timeline layout: one process lane per host process, one thread lane per
recording thread, and one reserved ``events`` lane where every
``events.jsonl`` record appears as an instant. Span ``ts`` is unix epoch
microseconds, the clock events carry in ``_ts``. The file layout is the
reference's, so either package's ``build_trace`` reads either package's
run directory.

Recording is O(1) per span (one lock, one append, one optional file
write; ``max_bytes`` rotates the file to ``<path>.1``) and the recorder
is disabled until ``configure()`` arms it.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid
from typing import Any, Callable, Iterator

import contextlib

RING_SIZE = 8192

# tid of the reserved per-process instant-event lane in trace.json
EVENTS_LANE_TID = 0


# ----------------------------------------------------------------------
# Trace context: the W3C-style (trace_id, span_id, parent_span_id) triple
# that follows one request across lanes (serving's read path).
# A context is a plain JSON dict; every hop that *receives* one records
# its own span as a child (``child_of``) and forwards its OWN context, so
# the chain is parent-linked end to end and ``build_trace`` can emit
# Perfetto flow arrows between the slices.

def new_trace() -> dict:
    """Root context for a fresh causal chain."""
    return {"trace_id": uuid.uuid4().hex[:16],
            "span_id": uuid.uuid4().hex[:16]}


def child_of(ctx: dict | None) -> dict:
    """Continue a received context: same trace, new span, parent linked.
    A None/malformed context starts a new root (never raises — tracing
    stays passive)."""
    if not isinstance(ctx, dict) or "trace_id" not in ctx:
        return new_trace()
    out = {"trace_id": str(ctx["trace_id"]),
           "span_id": uuid.uuid4().hex[:16]}
    if ctx.get("span_id"):
        out["parent_span_id"] = str(ctx["span_id"])
    return out


class SpanRecorder:
    """Thread-safe span sink: in-memory ring + optional JSONL file.

    ``max_bytes`` (0 = unbounded, the default) caps the JSONL sink:
    when a write pushes the file past the cap it is rotated to
    ``<path>.1`` (one generation kept) and a loud ``obs_rotated`` event
    marks the boundary, so 10^5-round runs cannot fill the disk.
    """

    def __init__(self, path: str | None = None, pid: int = 0,
                 enabled: bool = True, max_bytes: int = 0) -> None:
        self._lock = threading.Lock()
        self.ring: collections.deque = collections.deque(maxlen=RING_SIZE)
        self.pid = pid
        self.enabled = enabled
        self.path = path
        self.max_bytes = int(max_bytes)
        self.rotations = 0
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
               "ts": round(ts * 1e6, 1),          # µs — trace-event unit
               "dur": round(dur * 1e6, 1),
               "pid": self.pid, "tid": threading.get_ident()}
        if args:
            rec["args"] = args
        rotated_bytes = 0
        with self._lock:
            self.ring.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()
                if self.max_bytes and self._fh.tell() >= self.max_bytes:
                    rotated_bytes = self._rotate_locked()
        if rotated_bytes:
            # the bus lock is unrelated to ours, but emit outside our own
            # lock anyway: an event tap may legally record a span
            from feddrift_torch.obs import events as _events
            try:
                _events.emit("obs_rotated", file=os.path.basename(self.path),
                             rotated_bytes=rotated_bytes,
                             generation=self.rotations)
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

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "phase",
             on_close: Callable[[float, float], None] | None = None,
             **args: Any) -> Iterator[None]:
        """Context manager recording the enclosed interval.

        ``on_close(wall_start_s, duration_s)`` fires after the span is
        recorded — the single timing code path PhaseTracer and other
        accumulators hang their accounting on. The interval is measured
        whenever an ``on_close`` is given, even on a disabled recorder
        (the caller's accounting must not depend on sink state).
        """
        if not self.enabled and on_close is None:
            yield
            return
        t0 = time.time()
        p0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - p0
            self.record(name, t0, dt, cat, **args)
            if on_close is not None:
                on_close(t0, dt)

    def spans(self, name: str | None = None) -> list[dict]:
        with self._lock:
            out = list(self.ring)
        return out if name is None else [s for s in out if s["name"] == name]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "SpanRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ----------------------------------------------------------------------
# Process-local default recorder, mirroring obs.events: layers record
# through the module-level helpers, the runner re-points the sink per run.
# Starts disabled so library use without a run context costs ~nothing.
_recorder = SpanRecorder(None, enabled=False)
_rec_lock = threading.Lock()


def get_recorder() -> SpanRecorder:
    return _recorder


def configure(path: str | None, pid: int = 0,
              max_bytes: int = 0) -> SpanRecorder:
    """Install a fresh default recorder writing to ``path`` (None =
    memory-only, still enabled). Closes the previous recorder's sink."""
    global _recorder
    with _rec_lock:
        old, _recorder = _recorder, SpanRecorder(path, pid=pid,
                                                 max_bytes=max_bytes)
        old.close()
    return _recorder


def span(name: str, cat: str = "phase", **args: Any):
    return _recorder.span(name, cat, **args)


def record(name: str, ts: float, dur: float, cat: str = "phase",
           **args: Any) -> dict | None:
    return _recorder.record(name, ts, dur, cat, **args)


# ----------------------------------------------------------------------
# Chrome-trace export
def _load_jsonl(path: str) -> list[dict]:
    rows: list[dict] = []
    if not os.path.isfile(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue                         # tolerate a torn tail line
    return rows


def build_trace(run_dir: str) -> dict:
    """Chrome-trace-event JSON (object form) for one run directory.

    Sources ``spans.jsonl`` (duration events, ``ph: "X"``) and
    ``events.jsonl`` (instant events, ``ph: "i"``, one reserved lane per
    process). Output invariants: every
    event has name/ph/ts/pid/tid, durations are non-negative, the list is
    sorted by ts, and each (pid, tid) lane carries metadata naming it.

    Spans carrying trace-context args (``span_id`` + ``parent_span_id``,
    see ``new_trace``/``child_of``) additionally get Perfetto **flow
    arrows** (``ph: "s"``/``"f"`` pairs sharing an id) from each parent
    slice to its child slice — the rendering of one update's causal chain
    across pid lanes. A run with no trace contexts emits no flow events.
    """
    spans = _load_jsonl(os.path.join(run_dir, "spans.jsonl"))
    events = _load_jsonl(os.path.join(run_dir, "events.jsonl"))
    # rotated-out generations still belong to the timeline
    for fname in ("spans.jsonl.1", "events.jsonl.1"):
        extra = _load_jsonl(os.path.join(run_dir, fname))
        if fname.startswith("spans"):
            spans = extra + spans
        else:
            events = extra + events
    # sampling-profiler slices (obs/hostprof.py) share the span schema;
    # their string tids ("hostprof:<thread>") become their own named lanes
    spans = spans + _load_jsonl(os.path.join(run_dir, "hostprof.jsonl"))

    trace: list[dict] = []
    # (pid, raw tid) -> compact per-process tid; tid 0 = events lane
    lanes: dict[tuple[int, Any], int] = {}
    pids: set[int] = set()

    def lane(pid: int, raw_tid: Any) -> int:
        key = (pid, raw_tid)
        if key not in lanes:
            lanes[key] = 1 + sum(1 for (p, _) in lanes if p == pid)
        return lanes[key]

    for s in spans:
        pid = int(s.get("pid", 0))
        pids.add(pid)
        ev = {"name": s.get("name", "?"), "cat": s.get("cat", "phase"),
              "ph": "X", "ts": float(s.get("ts", 0.0)),
              "dur": max(float(s.get("dur", 0.0)), 0.0),
              "pid": pid, "tid": lane(pid, s.get("tid", "main"))}
        if s.get("args"):
            ev["args"] = s["args"]
        trace.append(ev)

    # Perfetto flow arrows between trace-context-linked spans: "s" bound
    # to the parent slice, "f" (bp "e": bind to enclosing slice) to the
    # child. Flow pairs are matched by (cat, id); ids are sequential —
    # each parent->child edge is its own arrow.
    by_span_id = {ev["args"]["span_id"]: ev for ev in trace
                  if "args" in ev and ev["args"].get("span_id")}
    flow_id = 0
    flows: list[dict] = []
    for ev in trace:
        parent_id = ev.get("args", {}).get("parent_span_id")
        parent = by_span_id.get(parent_id) if parent_id else None
        if parent is None or parent is ev:
            continue
        flow_id += 1
        flows.append({"name": "trace", "cat": "trace", "ph": "s",
                      "id": flow_id, "ts": parent["ts"],
                      "pid": parent["pid"], "tid": parent["tid"]})
        flows.append({"name": "trace", "cat": "trace", "ph": "f", "bp": "e",
                      "id": flow_id, "ts": max(ev["ts"], parent["ts"]),
                      "pid": ev["pid"], "tid": ev["tid"]})
    trace.extend(flows)

    for e in events:
        if "_ts" not in e or "kind" not in e:
            continue
        pid = int(e.get("pid", 0))
        pids.add(pid)
        args = {k: v for k, v in e.items()
                if k not in ("_ts", "kind", "pid") and _json_scalarish(v)}
        trace.append({"name": e["kind"], "cat": "event", "ph": "i",
                      "s": "t", "ts": round(float(e["_ts"]) * 1e6, 1),
                      "pid": pid, "tid": EVENTS_LANE_TID, "args": args})

    trace.sort(key=lambda ev: ev["ts"])

    meta: list[dict] = []
    for pid in sorted(pids):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": f"process {pid}"}})
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": EVENTS_LANE_TID, "args": {"name": "events"}})
    for (pid, raw), tid in sorted(lanes.items(), key=lambda kv: kv[1]):
        # descriptive raw tids (e.g. "hostprof:140…") name the lane
        # directly; integer thread idents keep the compact label
        name = raw if isinstance(raw, str) and not raw.isdigit() \
            else f"thread {tid}"
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": name}})

    return {"traceEvents": meta + trace, "displayTimeUnit": "ms"}


def _json_scalarish(v: Any) -> bool:
    return isinstance(v, (str, int, float, bool, list)) or v is None


def write_trace(run_dir: str, out_path: str | None = None) -> str:
    """Build + write ``trace.json`` for a run dir; returns the path."""
    trace = build_trace(run_dir)
    out_path = out_path or os.path.join(run_dir, "trace.json")
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return out_path
