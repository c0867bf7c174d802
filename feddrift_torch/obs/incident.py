"""Incident plane: trigger → debounce → self-contained forensic bundle.

A copy of ``feddrift_tpu/obs/incident.py``: an :class:`IncidentManager`
taps the event bus, debounces, and writes a bundle directory holding what
a post-mortem needs:

    <run_dir>/incidents/incident-NNN-<reason>/
        meta.json           trigger, evidence, pid/host/git/env,
                            checkpoint pointer
        flight.json         flight-recorder ring dump (obs/blackbox.py)
        trace.json          Perfetto-loadable trailing trace built from
                            the in-memory span + event rings
        alerts_tail.jsonl   tail of alerts.jsonl (rotated gen folded)
        host_ledger.json    last host_ledger event + live RSS/top-bytes
        hostprof.folded     folded stacks, when the sampler is armed
        config.json         the run's ExperimentConfig
        MANIFEST.json       checkpoint manifest copy, when one exists

The port does not merge per-replica fleet snapshots (``fleet/``): it has
no serving frontend.

Triggers (``TRIGGERS``, the reference's set): crit ``alert_raised``, any
``slo_burn``, ``replica_failed``/``replica_drained``, ``secure_degraded``,
``preempt_checkpoint``, a rolled-back ``canary_verdict`` — of which the
port's training run emits crit alerts and ``preempt_checkpoint`` — plus
the non-event paths: the runner's top-level exception guard (divergence
aborts arrive here as ``DivergenceError``), a chained ``sys.excepthook``
and a SIGQUIT handler (``install_process_hooks``) that dumps all thread
stacks through ``faulthandler`` before capturing.

Debounce: one bundle per ``debounce_s`` window — a storm of concurrent
triggers produces exactly one bundle; suppressed triggers are counted.
Exception/SIGQUIT captures bypass the window (``force=True``): a crash
after an alert-driven bundle still gets its traceback on disk.

The ``incident`` CLI verb (``incident_main``) renders the triage story
from a bundle — what fired, the dominant critical-path segment, recent
cluster decisions, replica/broker health at capture — host-side only.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import threading
import time
import traceback
from typing import Any, Callable, Optional

from feddrift_torch.obs import events as _events
from feddrift_torch.obs.events import _json_default

#: event kind -> predicate: does this record trigger a capture?
TRIGGERS: dict[str, Callable[[dict], bool]] = {
    "alert_raised": lambda rec: rec.get("severity") == "crit",
    "slo_burn": lambda rec: True,
    "replica_failed": lambda rec: True,
    "replica_drained": lambda rec: True,
    "secure_degraded": lambda rec: True,
    "preempt_checkpoint": lambda rec: True,
    "canary_verdict": lambda rec: rec.get("verdict") == "rollback",
}

#: environment prefixes worth bundling (accelerator + runtime knobs)
_ENV_PREFIXES = ("CUDA_", "NVIDIA_", "TORCH_", "PYTORCH_", "FEDDRIFT_",
                 "PYTHONHASHSEED")

_ALERTS_TAIL = 200          # alerts_tail.jsonl record bound


class IncidentManager:
    """Debounced trigger → bundle writer. Attach as a bus tap; see the
    module docstring for the trigger set and bundle layout."""

    def __init__(self, run_dir: Optional[str], recorder=None,
                 debounce_s: float = 30.0, max_bundles: int = 8,
                 config_json: Optional[str] = None,
                 ckpt_path: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.run_dir = run_dir
        self.recorder = recorder
        self.debounce_s = float(debounce_s)
        self.max_bundles = max(int(max_bundles), 1)
        self.config_json = config_json
        self.ckpt_path = ckpt_path
        # R3: re-entrant — writing a bundle emits incident_captured /
        # flight_dump, whose taps (this manager included) run on the
        # same thread while the capture lock is held
        self._lock = threading.RLock()
        self._clock = clock
        self._last_capture: Optional[float] = None
        self._seq = 0
        self.suppressed = 0
        self.captured: list[str] = []
        self._bus = None

    # -- wiring ---------------------------------------------------------
    def attach(self, bus) -> "IncidentManager":
        """Tap ``bus`` for trigger events; also becomes the process's
        current manager for the excepthook/SIGQUIT paths."""
        self._bus = bus
        bus.add_tap(self.observe)
        set_current(self)
        return self

    def detach(self) -> None:
        if self._bus is not None:
            try:
                self._bus.remove_tap(self.observe)
            except Exception:   # noqa: BLE001
                pass
            self._bus = None
        if current_manager() is self:
            set_current(None)

    # -- triggers -------------------------------------------------------
    def observe(self, rec: dict) -> None:
        kind = rec.get("kind")
        pred = TRIGGERS.get(kind)
        if pred is None:
            return
        try:
            if not pred(rec):
                return
        except Exception:   # noqa: BLE001 — a bad record never raises here
            return
        reason = kind
        if kind == "alert_raised" and rec.get("rule"):
            reason = f"alert:{rec['rule']}"
        elif kind == "slo_burn" and rec.get("objective"):
            reason = f"slo:{rec['objective']}"
        self.trigger(reason, evidence=rec)

    def on_exception(self, exc: BaseException, tb=None) -> Optional[str]:
        """Capture an abnormal termination (runner exception guard,
        chained excepthook). Bypasses the debounce window — a crash
        must land its traceback even right after an alert bundle."""
        text = "".join(traceback.format_exception(
            type(exc), exc, tb if tb is not None else exc.__traceback__))
        return self.trigger(
            f"exception:{type(exc).__name__}",
            evidence={"error": repr(exc)[:500],
                      "traceback": text[-8000:]},
            force=True)

    def trigger(self, reason: str, evidence: Optional[dict] = None,
                force: bool = False) -> Optional[str]:
        """Debounce and capture; returns the bundle path or None when
        suppressed (debounce window / no run_dir)."""
        if self.run_dir is None:
            return None
        with self._lock:
            now = self._clock()
            if (not force and self._last_capture is not None
                    and now - self._last_capture < self.debounce_s):
                self.suppressed += 1
                return None
            self._last_capture = now
            self._seq += 1
            try:
                path = self._write_bundle(reason, evidence)
            except Exception:   # noqa: BLE001 — capture must never take
                return None     # down the process it is diagnosing
            self.captured.append(path)
        return path

    # -- bundle writing -------------------------------------------------
    def _write_bundle(self, reason: str, evidence: Optional[dict]) -> str:
        safe = re.sub(r"[^a-zA-Z0-9_.-]+", "_", reason)[:48] or "trigger"
        name = f"incident-{self._seq:03d}-{safe}"
        bdir = os.path.join(self.run_dir, "incidents", name)
        while os.path.exists(bdir):            # fresh manager, old run dir
            self._seq += 1
            name = f"incident-{self._seq:03d}-{safe}"
            bdir = os.path.join(self.run_dir, "incidents", name)
        os.makedirs(bdir, exist_ok=True)

        dump: dict = {}
        if self.recorder is not None:
            try:
                dump = self.recorder.dump()
            except Exception:   # noqa: BLE001
                dump = {}
        _write_json(os.path.join(bdir, "flight.json"), dump)
        try:
            _events.emit("flight_dump", bundle=name,
                         records=len(dump.get("events", ())),
                         spans=len(dump.get("spans", ())),
                         alerts=len(dump.get("alerts", ())))
        except Exception:   # noqa: BLE001 — bus may be closed mid-crash
            pass

        _write_json(os.path.join(bdir, "trace.json"), trailing_trace(dump))
        self._write_alerts_tail(bdir)
        self._write_host(bdir, dump)
        self._write_hostprof(bdir)
        if self.config_json:
            with open(os.path.join(bdir, "config.json"), "w") as f:
                f.write(self.config_json)
        self._copy_manifest(bdir)

        meta = {
            "bundle": name,
            "reason": reason,
            "evidence": _jsonable(evidence),
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "host": _hostname(),
            "git_sha": _git_sha(),
            "python": sys.version.split()[0],
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(_ENV_PREFIXES)},
            "checkpoint": self._ckpt_pointer(),
            "ring": {"events": len(dump.get("events", ())),
                     "observed": dump.get("observed"),
                     "capacity": dump.get("capacity")},
            "suppressed_triggers": self.suppressed,
        }
        _write_json(os.path.join(bdir, "meta.json"), meta)
        try:
            _events.emit("incident_captured", reason=reason, bundle=name,
                         path=bdir, fleet=False,
                         records=meta["ring"]["events"])
        except Exception:   # noqa: BLE001
            pass
        self._prune()
        return bdir

    def _write_alerts_tail(self, bdir: str) -> None:
        if not self.run_dir:
            return
        rows: list[str] = []
        for fname in ("alerts.jsonl.1", "alerts.jsonl"):
            path = os.path.join(self.run_dir, fname)
            if os.path.isfile(path):
                try:
                    with open(path) as f:
                        rows.extend(ln for ln in f if ln.strip())
                except OSError:
                    pass
        if rows:
            with open(os.path.join(bdir, "alerts_tail.jsonl"), "w") as f:
                f.writelines(rows[-_ALERTS_TAIL:])

    def _write_host(self, bdir: str, dump: dict) -> None:
        from feddrift_torch.obs import hostprof
        last_ledger = None
        for rec in reversed(dump.get("events", ())):
            if rec.get("kind") == "host_ledger":
                last_ledger = rec
                break
        try:
            top = hostprof.ledger().top_bytes(5)
        except Exception:   # noqa: BLE001
            top = []
        _write_json(os.path.join(bdir, "host_ledger.json"),
                    {"rss_bytes": hostprof.rss_bytes(),
                     "top_bytes": top,
                     "last_host_ledger": last_ledger})

    def _write_hostprof(self, bdir: str) -> None:
        from feddrift_torch.obs import hostprof
        prof = hostprof.get_profiler()
        if prof is None:
            return
        try:
            text = prof.folded_text()
        except Exception:   # noqa: BLE001
            return
        if text:
            with open(os.path.join(bdir, "hostprof.folded"), "w") as f:
                f.write(text)

    def _copy_manifest(self, bdir: str) -> None:
        ckpt = self.ckpt_path
        if not ckpt:
            return
        src = os.path.join(ckpt, "MANIFEST.json")
        if os.path.isfile(src):
            try:
                with open(src) as f:
                    data = f.read()
                with open(os.path.join(bdir, "MANIFEST.json"), "w") as f:
                    f.write(data)
            except OSError:
                pass

    def _ckpt_pointer(self) -> Optional[dict]:
        if not self.ckpt_path:
            return None
        manifest = os.path.join(self.ckpt_path, "MANIFEST.json")
        out: dict[str, Any] = {"path": self.ckpt_path,
                               "exists": os.path.isfile(manifest)}
        if out["exists"]:
            try:
                with open(manifest) as f:
                    m = json.load(f)
                out["iteration"] = m.get("iteration")
                out["global_round"] = m.get("global_round")
            except (OSError, ValueError):
                pass
        return out

    def _prune(self) -> None:
        """Keep the newest ``max_bundles`` bundle dirs."""
        import shutil
        root = os.path.join(self.run_dir, "incidents")
        try:
            names = sorted(n for n in os.listdir(root)
                           if n.startswith("incident-"))
        except OSError:
            return
        for n in names[:-self.max_bundles]:
            shutil.rmtree(os.path.join(root, n), ignore_errors=True)


# ----------------------------------------------------------------------
# process hooks: excepthook + SIGQUIT (stack dump via faulthandler, then
# capture). The CLI run path installs these; tests install them in a
# subprocess. The hooks resolve the manager lazily through the
# process-local slot so re-configuring a run re-points them for free.
_current: Optional[IncidentManager] = None
_cur_lock = threading.Lock()
_hooks_installed = False


def current_manager() -> Optional[IncidentManager]:
    with _cur_lock:
        return _current


def set_current(manager: Optional[IncidentManager]) -> None:
    global _current
    with _cur_lock:
        _current = manager


def install_process_hooks(manager: Optional[IncidentManager] = None,
                          sigquit: bool = True,
                          excepthook: bool = True,
                          faulthandler_file=None) -> None:
    """Arm crash-time capture for this process.

    - ``sys.excepthook`` is chained: the current manager captures (with
      traceback, bypassing debounce), then the previous hook runs.
    - SIGQUIT gets a handler that dumps every thread's stack through
      ``faulthandler.dump_traceback`` (to ``faulthandler_file`` when
      given, stderr otherwise) and then captures a bundle — the classic
      "the process is wedged, kill -QUIT it and read the black box".
      Signal installation is main-thread-only, like resilience/preempt.

    Idempotent: repeated calls re-point the manager but install each
    hook once.
    """
    global _hooks_installed
    if manager is not None:
        set_current(manager)
    if _hooks_installed:
        return
    _hooks_installed = True
    if excepthook:
        prev = sys.excepthook

        def _hook(tp, val, tb):
            m = current_manager()
            if m is not None:
                try:
                    m.on_exception(val, tb=tb)
                except Exception:   # noqa: BLE001
                    pass
            prev(tp, val, tb)

        sys.excepthook = _hook
    if sigquit and hasattr(os, "kill") \
            and threading.current_thread() is threading.main_thread():
        import faulthandler
        import signal

        def _on_sigquit(signum, frame):
            try:
                faulthandler.dump_traceback(
                    file=faulthandler_file or sys.stderr, all_threads=True)
            except Exception:   # noqa: BLE001
                pass
            m = current_manager()
            if m is not None:
                m.trigger("sigquit", evidence={"signal": "SIGQUIT"},
                          force=True)

        try:
            signal.signal(signal.SIGQUIT, _on_sigquit)
        except (ValueError, OSError, AttributeError):
            pass                      # non-main thread / platform without it


# ----------------------------------------------------------------------
# small helpers
def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, default=_json_default)


def _jsonable(obj):
    """Round-trip through the bus's tolerant encoder so numpy payloads
    in trigger evidence never poison meta.json."""
    if obj is None:
        return None
    try:
        return json.loads(json.dumps(obj, default=_json_default))
    except (TypeError, ValueError):
        return {"repr": repr(obj)[:500]}


def _hostname() -> str:
    import socket
    try:
        return socket.gethostname()
    except OSError:
        return "?"


def _git_sha() -> Optional[str]:
    """Best-effort HEAD sha of the package checkout; None outside git."""
    import subprocess
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=pkg,
                             capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def trailing_trace(dump: dict) -> dict:
    """Perfetto-loadable Chrome-trace JSON built from an in-memory ring
    dump (no files): span rings become duration slices, the event ring
    becomes instants on the reserved per-process events lane — the same
    layout ``obs.spans.build_trace`` gives a full run dir."""
    trace: list[dict] = []
    pids: set[int] = set()
    lanes: dict[tuple, int] = {}

    def lane(pid: int, raw_tid) -> int:
        key = (pid, raw_tid)
        if key not in lanes:
            lanes[key] = 1 + sum(1 for (p, _) in lanes if p == pid)
        return lanes[key]

    for s in dump.get("spans", ()):
        pid = int(s.get("pid", 0))
        pids.add(pid)
        ev = {"name": s.get("name", "?"), "cat": s.get("cat", "phase"),
              "ph": "X", "ts": float(s.get("ts", 0.0)),
              "dur": max(float(s.get("dur", 0.0)), 0.0),
              "pid": pid, "tid": lane(pid, s.get("tid", "main"))}
        if s.get("args"):
            ev["args"] = _jsonable(s["args"])
        trace.append(ev)
    for e in dump.get("events", ()):
        if "_ts" not in e or "kind" not in e:
            continue
        pid = int(e.get("pid", 0))
        pids.add(pid)
        trace.append({"name": e["kind"], "cat": "event", "ph": "i",
                      "s": "t", "ts": round(float(e["_ts"]) * 1e6, 1),
                      "pid": pid, "tid": 0})
    trace.sort(key=lambda ev: ev["ts"])
    meta: list[dict] = []
    for pid in sorted(pids):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": f"process {pid}"}})
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": 0, "args": {"name": "events"}})
    for (pid, _raw), tid in sorted(lanes.items(), key=lambda kv: kv[1]):
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": f"thread {tid}"}})
    return {"traceEvents": meta + trace, "displayTimeUnit": "ms"}


# ----------------------------------------------------------------------
# triage CLI: python -m feddrift_torch incident <bundle-or-run_dir>
def resolve_bundle(target: str) -> Optional[str]:
    """A bundle dir (holds meta.json), or the NEWEST bundle under
    ``<target>/incidents/``; None when neither matches."""
    if os.path.isfile(os.path.join(target, "meta.json")):
        return target
    root = os.path.join(target, "incidents")
    if os.path.isdir(root):
        names = sorted(n for n in os.listdir(root)
                       if os.path.isfile(os.path.join(root, n, "meta.json")))
        if names:
            return os.path.join(root, names[-1])
    return None


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _fmt_ev(rec: dict) -> str:
    it = rec.get("iteration")
    head = f"it {it}" if it is not None else "-"
    return f"{head:>8}  {rec.get('kind', '?')}"


def render_incident(bdir: str, meta: dict, flight: dict) -> str:
    """The triage story: what fired, the dominant critical-path
    segment, recent swaps/canary verdicts, replica/broker health."""
    lines: list[str] = []
    lines.append(f"== incident {meta.get('bundle', os.path.basename(bdir))} "
                 f"==")
    ts = meta.get("ts")
    when = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts)) \
        if isinstance(ts, (int, float)) else "?"
    lines.append(f"reason      {meta.get('reason', '?')}")
    lines.append(f"captured    {when}  pid {meta.get('pid', '?')}  "
                 f"host {meta.get('host', '?')}")
    if meta.get("git_sha"):
        lines.append(f"git         {meta['git_sha']}")
    ckpt = meta.get("checkpoint") or {}
    if ckpt:
        extra = f" (iteration {ckpt.get('iteration')})" \
            if ckpt.get("iteration") is not None else ""
        state = "present" if ckpt.get("exists") else "MISSING"
        lines.append(f"checkpoint  {ckpt.get('path')} — {state}{extra}")

    # -- what fired -----------------------------------------------------
    lines.append("")
    lines.append("-- what fired --")
    ev = meta.get("evidence") or {}
    msg = (ev.get("message") or ev.get("error") or ev.get("reason")
           or ev.get("signal"))
    if ev.get("rule"):
        lines.append(f"rule {ev['rule']} ({ev.get('severity', '?')})")
    if ev.get("objective"):
        lines.append(f"slo objective {ev['objective']}")
    if msg:
        lines.append(str(msg))
    if ev.get("traceback"):
        tb = str(ev["traceback"]).strip().splitlines()
        lines.extend(tb[-12:])
    alerts = flight.get("alerts") or []
    if alerts:
        lines.append(f"recent alerts ({len(alerts)} in ring):")
        for a in alerts[-5:]:
            lines.append(f"  {_fmt_ev(a)}  {a.get('rule') or a.get('objective') or ''}"
                         f" {a.get('severity', '')}".rstrip())

    # -- critical path at capture --------------------------------------
    breakdowns = flight.get("round_breakdowns") or []
    if breakdowns:
        last = breakdowns[-1]
        segs = last.get("segments") or {}
        lines.append("")
        lines.append("-- critical path (last round_breakdown, iteration "
                     f"{last.get('iteration', '?')}) --")
        wall = float(last.get("wall_s") or 0.0)
        if segs:
            dom = max(segs.items(), key=lambda kv: kv[1])
            frac = dom[1] / wall if wall > 0 else 0.0
            lines.append(f"dominant segment: {dom[0]} "
                         f"({dom[1]:.4f}s of {wall:.4f}s wall, "
                         f"{100 * frac:.0f}%)")
            for k, v in sorted(segs.items(), key=lambda kv: -kv[1])[:5]:
                lines.append(f"  {k:<22} {v:.4f}s")
        hof = last.get("host_overhead_frac")
        if hof is not None:
            lines.append(f"host_overhead_frac: {hof}")

    # -- swaps & canaries ----------------------------------------------
    swap_kinds = ("pool_swapped", "canary_started", "canary_verdict",
                  "cluster_merge", "cluster_split", "cluster_create",
                  "cluster_delete")
    swaps = [e for e in (flight.get("events") or ())
             if e.get("kind") in swap_kinds]
    if swaps:
        lines.append("")
        lines.append("-- recent swaps / canary verdicts --")
        for e in swaps[-8:]:
            detail = ""
            if e.get("lineage_ids"):
                detail = " lineage " + "<-".join(
                    str(x) for x in e["lineage_ids"])
            if e.get("kind") == "canary_verdict":
                detail += f" -> {e.get('verdict', '?')}" \
                          f" ({e.get('reason', '?')})"
            if e.get("version") is not None:
                detail += f" version {e['version']}"
            lines.append(f"  {_fmt_ev(e)}{detail}")

    # -- replica / broker health ---------------------------------------
    health_kinds = ("replica_failed", "replica_drained", "frontend_shed",
                    "conn_drop", "conn_reconnect", "heartbeat_missed")
    health = [e for e in (flight.get("events") or ())
              if e.get("kind") in health_kinds]
    fleet = meta.get("fleet") or {}
    if health or fleet:
        lines.append("")
        lines.append("-- replica / broker health at capture --")
        for e in health[-8:]:
            detail = ""
            if e.get("replica"):
                detail = f" replica {e['replica']}"
            if e.get("reason"):
                detail += f" ({e['reason']})"
            if e.get("remaining") is not None:
                detail += f" remaining={e['remaining']}"
            lines.append(f"  {_fmt_ev(e)}{detail}")
        if fleet:
            dead = fleet.get("dead") or []
            if dead:
                lines.append(f"DEAD REPLICAS: {', '.join(dead)}")
            lanes = fleet.get("lanes") or []
            lines.append(f"merged fleet snapshots: "
                         f"{', '.join(lanes) if lanes else '(none)'}")

    # -- bundle contents ------------------------------------------------
    lines.append("")
    lines.append("-- bundle files --")
    for root, _dirs, files in sorted(os.walk(bdir)):
        rel = os.path.relpath(root, bdir)
        for fn in sorted(files):
            p = os.path.join(root, fn)
            rp = fn if rel == "." else os.path.join(rel, fn)
            try:
                sz = os.path.getsize(p)
            except OSError:
                sz = 0
            lines.append(f"  {rp:<28} {sz} bytes")
    return "\n".join(lines)


def incident_main(argv=None) -> int:
    """``python -m feddrift_torch incident <bundle-or-run_dir>`` — render
    the post-mortem triage story. Host-side only (no torch)."""
    ap = argparse.ArgumentParser(
        prog="python -m feddrift_torch incident",
        description="render the triage story from an incident bundle "
                    "(or the newest bundle under <run_dir>/incidents/)")
    ap.add_argument("target", help="bundle dir or run dir")
    ap.add_argument("--json", action="store_true",
                    help="print bundle meta + flight summary as JSON")
    args = ap.parse_args(argv)
    bdir = resolve_bundle(args.target)
    if bdir is None:
        print(f"no incident bundle found under {args.target!r} "
              "(expected meta.json or an incidents/ directory)",
              file=sys.stderr)
        return 1
    meta = _load_json(os.path.join(bdir, "meta.json")) or {}
    flight = _load_json(os.path.join(bdir, "flight.json")) or {}
    if args.json:
        print(json.dumps({
            "bundle": bdir, "meta": meta,
            "ring": {"events": len(flight.get("events", ())),
                     "alerts": len(flight.get("alerts", ())),
                     "spans": len(flight.get("spans", ()))},
        }, indent=2))
        return 0
    print(render_incident(bdir, meta, flight))
    return 0
