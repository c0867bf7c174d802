"""Rule-based run-health monitor: declarative rules over the event
stream → ``alert_raised`` events + ``<run_dir>/alerts.jsonl``.

A copy of ``feddrift_tpu/obs/alerts.py`` with all six rules. The port
emits the trigger kinds of ``cluster_churn`` (``cluster_state``),
``ari_collapse`` (``cluster_assign`` with ``oracle_ari``),
``divergence_byzantine`` (``divergence_detected``) and ``eval_gap_stall``
(``eval``); it has no fault injector, Byzantine schedule or cohort
quorum yet, so ``client_outage`` and ``quorum_miss`` never fire and
``divergence_byzantine`` finds no ``byzantine_injected`` evidence.

The telemetry layers record *what* happened; this module watches the
stream for the patterns that, in practice, mean a run needs a human:
cluster-count churn (the pool thrashing spawn/merge instead of
converging), oracle-ARI collapse (clustering quality falling off a
cliff after having recovered the concepts), divergence rollbacks
co-occurring with an active Byzantine schedule (a defense being
overwhelmed rather than random numeric noise), a stalled
generalization gap, and client outages.

Two evaluation modes, same rules:

- **live** — the runner attaches an :class:`AlertMonitor` as an event-bus
  tap (``EventBus.add_tap``); every emitted event is observed on the
  emitting thread, fired alerts are appended to ``alerts.jsonl``
  (open-append-close per alert: alerts are rare and the file survives a
  crash mid-run) and re-emitted as ``alert_raised`` events so the
  ordinary event stream carries them too. Gated by ``cfg.alerts``.
- **offline** — ``report <run_dir> --follow`` feeds the tail of
  ``events.jsonl`` through a detached monitor (no file, no bus), so runs
  recorded without live alerting still get scored.

A rule is data: a name, severity, the event kinds that can trigger its
evaluation, and a check function over the monitor's bounded recent-event
windows. Checks run only on their trigger kinds and keep O(window)
state, so the live tap stays off the hot path's critical section (taps
run after the bus lock is released).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# ----------------------------------------------------------------------
# rule definition
@dataclass
class Rule:
    """One declarative health rule.

    ``check(monitor, event)`` runs when an event of a kind in ``kinds``
    is observed and the rule is off cooldown; returning a payload dict
    raises the alert (the dict becomes the alert's evidence fields),
    returning None stays quiet."""
    name: str
    severity: str                      # "warn" | "crit"
    description: str
    kinds: tuple
    check: Callable[["AlertMonitor", dict], Optional[dict]]
    cooldown: int = 1                  # min iterations between firings


# The structural cluster decisions counted by the churn rule.
CHURN_KINDS = ("cluster_create", "cluster_merge", "cluster_delete",
               "cluster_split")


def default_rules(churn_threshold: int = 4, churn_window: int = 3,
                  ari_arm: float = 0.5, ari_drop: float = 0.3,
                  byz_round_window: int = 16,
                  stall_evals: int = 4, stall_gap: float = 0.15,
                  stall_eps: float = 0.01,
                  quorum_miss_threshold: int = 2,
                  quorum_miss_window: int = 3) -> list[Rule]:
    """The built-in rule set, thresholds exposed for cfg overrides."""

    def check_churn(mon: "AlertMonitor", rec: dict) -> Optional[dict]:
        lo = mon.iteration - churn_window
        n = sum(1 for k in CHURN_KINDS for e in mon.recent[k]
                if (e.get("iteration") or 0) > lo)
        if n > churn_threshold:
            return {"message": f"{n} cluster create/merge/delete/split "
                               f"events in the last {churn_window} "
                               f"iterations (> {churn_threshold}) — the "
                               "pool is thrashing instead of converging",
                    "count": n, "window": churn_window,
                    "threshold": churn_threshold}
        return None

    def check_ari_collapse(mon: "AlertMonitor", rec: dict) -> Optional[dict]:
        ari = rec.get("oracle_ari")
        if ari is None:
            return None
        best = mon.state.get("best_ari", 0.0)
        mon.state["best_ari"] = max(best, ari)
        if best >= ari_arm and ari <= best - ari_drop:
            return {"message": f"oracle ARI collapsed to {ari:.3f} from a "
                               f"best of {best:.3f} — clustering quality "
                               "lost the recovered concepts",
                    "ari": ari, "best_ari": best}
        return None

    def check_div_byz(mon: "AlertMonitor", rec: dict) -> Optional[dict]:
        r = rec.get("round")
        byz = [e for e in mon.recent["byzantine_injected"]
               if r is None or e.get("round") is None
               or abs(e["round"] - r) <= byz_round_window]
        if byz:
            modes = sorted({e.get("mode", "?") for e in byz})
            return {"message": "divergence rollback while a Byzantine "
                               f"schedule is active (modes {modes}) — the "
                               "configured aggregation may be overwhelmed",
                    "reason": rec.get("reason"), "byz_modes": modes}
        return None

    def check_eval_stall(mon: "AlertMonitor", rec: dict) -> Optional[dict]:
        evs = list(mon.recent["eval"])[-stall_evals:]
        if len(evs) < stall_evals:
            return None
        gaps, accs = [], []
        for e in evs:
            tr, te = e.get("train_acc"), e.get("test_acc")
            if tr is None or te is None:
                return None
            gaps.append(tr - te)
            accs.append(te)
        if min(gaps) > stall_gap and max(accs) - min(accs) < stall_eps:
            return {"message": f"generalization gap stalled: train-test gap "
                               f"> {stall_gap} for the last {stall_evals} "
                               f"evals with Test/Acc flat at "
                               f"{accs[-1]:.3f} — likely an unadapted "
                               "concept drift",
                    "gap": round(min(gaps), 4),
                    "test_acc": round(accs[-1], 4)}
        return None

    def check_outage(mon: "AlertMonitor", rec: dict) -> Optional[dict]:
        if rec["kind"] == "client_killed":
            return {"message": f"client {rec.get('client')} permanently "
                               "killed — cluster decisions now run on a "
                               "reduced population",
                    "clients": [rec.get("client")]}
        clients = rec.get("clients") or []
        if clients:
            return {"message": f"failure detector suspects clients "
                               f"{clients} — their accuracy evidence is "
                               "stale",
                    "clients": clients}
        return None

    def check_quorum_miss(mon: "AlertMonitor", rec: dict) -> Optional[dict]:
        lo = mon.iteration - quorum_miss_window
        n = sum(1 for e in mon.recent["round_degraded"]
                if (e.get("iteration") or 0) > lo)
        if n >= quorum_miss_threshold:
            return {"message": f"{n} quorum-missed (degraded) rounds in the "
                               f"last {quorum_miss_window} iterations — the "
                               "cohort repeatedly cannot reach quorum; raise "
                               "cohort_overprovision / round_deadline or "
                               "lower quorum_frac",
                    "count": n, "window": quorum_miss_window,
                    "threshold": quorum_miss_threshold,
                    "quorum": rec.get("quorum"),
                    "on_time": rec.get("on_time")}
        return None

    return [
        Rule("cluster_churn", "warn",
             "structural cluster events per window above threshold",
             ("cluster_state",), check_churn, cooldown=1),
        Rule("ari_collapse", "crit",
             "oracle ARI dropped sharply from its best",
             ("cluster_assign",), check_ari_collapse, cooldown=1),
        Rule("divergence_byzantine", "crit",
             "divergence rollback co-occurring with an active adversary",
             ("divergence_detected",), check_div_byz, cooldown=1),
        Rule("eval_gap_stall", "warn",
             "train-test gap stalled across consecutive evals",
             ("eval",), check_eval_stall, cooldown=5),
        Rule("client_outage", "warn",
             "permanent kill or failure-suspected clients",
             ("client_killed", "failure_suspected"), check_outage,
             cooldown=1),
        Rule("quorum_miss", "crit",
             "repeated quorum-missed (degraded) rounds within the window",
             ("round_degraded",), check_quorum_miss, cooldown=2),
    ]


# ----------------------------------------------------------------------
# the monitor
RECENT_WINDOW = 512


class AlertMonitor:
    """Evaluates rules over observed events; thread-safe (the live tap
    runs on whatever thread emitted — runner main, broker background)."""

    def __init__(self, rules: Optional[list[Rule]] = None,
                 path: Optional[str] = None, bus=None,
                 max_bytes: int = 0) -> None:
        import collections
        self.rules = rules if rules is not None else default_rules()
        self.path = path
        self.max_bytes = int(max_bytes)   # alerts.jsonl size cap (0 = off)
        self.bus = bus
        self.state: dict[str, Any] = {}       # rule scratch (best_ari, ...)
        self.alerts: list[dict] = []          # every raised record
        self.iteration = 0
        # re-entrant: _raise (lock held) emits alert_raised through the
        # bus, and if that write trips the size-cap rotation the bus taps
        # this same thread with the obs_rotated record -> observe again
        self._lock = threading.RLock()
        self._last_fired: dict[str, int] = {}
        tracked = set(CHURN_KINDS) | {"byzantine_injected"}
        for r in self.rules:
            tracked.update(r.kinds)
        self.recent: dict[str, Any] = {
            k: collections.deque(maxlen=RECENT_WINDOW) for k in tracked}
        self._by_kind: dict[str, list[Rule]] = {}
        for r in self.rules:
            for k in r.kinds:
                self._by_kind.setdefault(k, []).append(r)

    # -- wiring ---------------------------------------------------------
    def attach(self, bus) -> "AlertMonitor":
        """Register as a live tap on an EventBus; fired alerts are
        re-emitted through that bus as alert_raised events."""
        self.bus = bus
        bus.add_tap(self.observe)
        return self

    # -- evaluation -----------------------------------------------------
    def observe(self, rec: dict) -> None:
        """Feed one event record (live tap or offline replay)."""
        kind = rec.get("kind")
        if kind is None or kind == "alert_raised":
            return                      # never recurse on our own output
        with self._lock:
            it = rec.get("iteration")
            if isinstance(it, int) and it > self.iteration:
                self.iteration = it
            if kind in self.recent:
                self.recent[kind].append(rec)
            for rule in self._by_kind.get(kind, ()):
                last = self._last_fired.get(rule.name)
                if last is not None and \
                        self.iteration - last < rule.cooldown:
                    continue
                payload = rule.check(self, rec)
                if payload:
                    self._raise(rule, payload)

    def _raise(self, rule: Rule, payload: dict) -> None:
        # lock already held; bus emission happens with OUR lock held but
        # the bus lock free (taps run unlocked). observe() drops
        # alert_raised before taking the lock, and the one genuine
        # re-entry — a size-cap rotation tripped by the alert_raised
        # write taps us back with obs_rotated — is safe on the RLock.
        self._last_fired[rule.name] = self.iteration
        fields = {"rule": rule.name, "severity": rule.severity, **payload}
        if self.bus is not None:
            rec = self.bus.emit("alert_raised", **fields)
        else:
            rec = {"_ts": time.time(), "kind": "alert_raised",
                   "iteration": self.iteration, **fields}
        self.alerts.append(rec)
        try:
            from feddrift_torch.obs.instruments import registry
            registry().counter("alerts_raised", rule=rule.name).inc()
        except Exception:
            pass
        if self.path:
            append_alert(self.path, rec, max_bytes=self.max_bytes)


# per-path rotation generation counters for the append_alert size cap
# (the sink is open-append-close, so generation state lives here, not on
# a file handle like the events/spans sinks)
_rotations: dict[str, int] = {}
_rot_lock = threading.Lock()


def append_alert(path: str, rec: dict, max_bytes: int = 0) -> None:
    """Append one record to an alerts.jsonl sink (open-append-close, so
    concurrent writers — the alert monitor and the SLO engine in
    obs/live.py — interleave whole lines, never partial ones).

    ``max_bytes`` > 0 applies the same size-cap rotation events/spans
    get (``cfg.obs_max_file_mb``): when the write pushes the file past
    the cap it rotates to ``<path>.1`` (one generation kept) with a loud
    ``obs_rotated`` event — a long-running service with a flapping rule
    must not grow alerts.jsonl unboundedly."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rotated_bytes = generation = 0
    with _rot_lock:
        with open(path, "a") as f:
            f.write(json.dumps(rec, default=_json_default) + "\n")
            if max_bytes and f.tell() >= max_bytes:
                rotated_bytes = f.tell()
        if rotated_bytes:
            try:
                os.replace(path, path + ".1")
            except OSError:
                rotated_bytes = 0
            else:
                generation = _rotations[path] = _rotations.get(path, 0) + 1
    if rotated_bytes:
        from feddrift_torch.obs import events as _events
        try:
            _events.emit("obs_rotated", file=os.path.basename(path),
                         rotated_bytes=rotated_bytes,
                         generation=generation)
        except Exception:   # noqa: BLE001 — observability stays passive
            pass


def _json_default(o):
    tolist = getattr(o, "tolist", None)
    return tolist() if tolist is not None else str(o)


def replay(events: list[dict],
           rules: Optional[list[Rule]] = None) -> list[dict]:
    """Offline evaluation: run the rules over a recorded event stream and
    return the alerts they raise (report --follow / post-hoc triage)."""
    mon = AlertMonitor(rules=rules)
    for e in events:
        mon.observe(e)
    return mon.alerts
