"""Always-on flight recorder: the black box behind incident bundles.

A copy of ``feddrift_tpu/obs/blackbox.py``.

Post-hoc triage reads the JSONL files a
run wrote — which is exactly the evidence that is missing when a process
dies with its buffers unflushed, or when a serving replica fails on a
host whose run dir nobody is tailing. This module keeps the *recent
past* resident: bounded in-memory ring buffers over the last N observed
events, the alert records among them, the per-iteration
``round_breakdown`` records, and periodic instrument snapshots. Span
history is NOT duplicated — the process-wide ``obs.spans`` recorder
already keeps its own ring, and ``dump()`` folds it in at capture time.

Cost model: ``observe()`` is a bus tap — one re-entrant lock acquire, one-to-two
deque appends, no serialization, no I/O. Rings are sized in **records,
not bytes**: capacity is a count, eviction is the deque's own maxlen,
and nothing is JSON-encoded until ``dump()`` runs on the (rare) capture
path. The recorder holds references to the same dicts the bus ring
holds, so the marginal memory is the deque slots themselves.

``obs/incident.py`` owns *when* to capture (triggers, debounce, bundle
layout); this module owns *what* is still in memory when it does.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Optional

#: default ring capacity (records) for the main event ring; the alert /
#: breakdown / instrument-snapshot rings are sized down from it because
#: their records are rarer and individually heavier.
DEFAULT_CAPACITY = 512

# the event kinds teed into the dedicated alert ring so a dump keeps an
# alert trail even after the main ring wrapped past the firing
_ALERT_KINDS = ("alert_raised", "slo_burn")


class FlightRecorder:
    """Bounded rings over the recent event stream; attach as a bus tap.

    Thread-safe: ``observe`` runs on whatever thread emitted (runner
    main, broker background, serving dispatchers). The lock is
    re-entrant per the R3 tap discipline — ``dump()`` may be reached
    from code that itself runs under a tap.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 alerts_capacity: Optional[int] = None,
                 breakdowns_capacity: Optional[int] = None,
                 snapshots_capacity: int = 16,
                 enabled: bool = True) -> None:
        capacity = max(int(capacity), 8)
        self.capacity = capacity
        # R3: re-entrant — a dump on the capture path can emit
        # (flight_dump) and tap straight back into observe()
        self._lock = threading.RLock()
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.alerts: collections.deque = collections.deque(
            maxlen=alerts_capacity if alerts_capacity is not None
            else max(capacity // 4, 8))
        self.breakdowns: collections.deque = collections.deque(
            maxlen=breakdowns_capacity if breakdowns_capacity is not None
            else max(capacity // 8, 8))
        self.snapshots: collections.deque = collections.deque(
            maxlen=max(int(snapshots_capacity), 1))
        self.enabled = enabled
        self.observed = 0                  # lifetime count (wraparound proof)
        self._bus = None

    # -- wiring ---------------------------------------------------------
    def attach(self, bus) -> "FlightRecorder":
        """Register as a live tap on an EventBus."""
        self._bus = bus
        bus.add_tap(self.observe)
        return self

    def detach(self) -> None:
        if self._bus is not None:
            try:
                self._bus.remove_tap(self.observe)
            except Exception:   # noqa: BLE001 — bus may be gone already
                pass
            self._bus = None

    # -- recording ------------------------------------------------------
    def observe(self, rec: dict) -> None:
        """Feed one event record (the bus tap). O(1): lock + append."""
        if not self.enabled:
            return
        kind = rec.get("kind")
        if kind is None:
            return
        with self._lock:
            self.observed += 1
            self.events.append(rec)
            if kind in _ALERT_KINDS:
                self.alerts.append(rec)
            elif kind == "round_breakdown":
                self.breakdowns.append(rec)

    def snapshot_instruments(self, reg=None) -> Optional[dict]:
        """Ring one instrument snapshot (runner iteration tail / capture
        path). Heavier than ``observe`` — every instrument takes its
        lock — so it is called per *iteration*, never per event."""
        if not self.enabled:
            return None
        from feddrift_torch.obs.instruments import registry
        snap = {"ts": round(time.time(), 3),
                "metrics": (reg if reg is not None else registry()).snapshot()}
        with self._lock:
            self.snapshots.append(snap)
        return snap

    # -- capture --------------------------------------------------------
    def dump(self, events_limit: Optional[int] = None,
             include_spans: bool = True,
             include_instruments: bool = True) -> dict:
        """Serialize-ready snapshot of every ring. ``events_limit``
        bounds the event tail (broker-carried per-replica snapshots);
        None keeps the whole ring. Values are the live record dicts —
        callers serialize with ``obs.events._json_default``."""
        with self._lock:
            events = list(self.events)
            out: dict[str, Any] = {
                "captured_ts": round(time.time(), 3),
                "observed": self.observed,
                "capacity": self.capacity,
                "alerts": [dict(a) for a in self.alerts],
                "round_breakdowns": [dict(b) for b in self.breakdowns],
                "instrument_snapshots": list(self.snapshots),
            }
        if events_limit is not None and len(events) > events_limit:
            events = events[-int(events_limit):]
        out["events"] = [dict(e) for e in events]
        if include_spans:
            from feddrift_torch.obs import spans as _spans
            out["spans"] = _spans.get_recorder().spans()
        if include_instruments:
            from feddrift_torch.obs.instruments import registry
            out["instruments"] = registry().snapshot()
        return out


# ----------------------------------------------------------------------
# Process-local default recorder, mirroring obs.events / obs.spans: the
# runner (or a serving frontend script) configures it once per run,
# library layers reach it through get_flight_recorder(). It starts
# UNATTACHED: a process that never configures pays nothing.
_recorder = FlightRecorder()
_rec_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    return _recorder


def configure(capacity: int = DEFAULT_CAPACITY, **kwargs) -> FlightRecorder:
    """Install a fresh process-wide recorder (detaching the previous
    one from whatever bus it tapped). Caller attaches it to a bus."""
    global _recorder
    with _rec_lock:
        old, _recorder = _recorder, FlightRecorder(capacity=capacity,
                                                   **kwargs)
        old.detach()
    return _recorder
