"""Round critical-path attribution from a run's recorded streams.

    python -m feddrift_torch critical_path <run_dir> [--json] [--flame]

Copy of ``feddrift_tpu/obs/critical_path.py``; it reads either
package's run directory. Replays ``spans.jsonl`` + ``events.jsonl``
(rotated ``.1`` generations included) into a per-iteration segment table: for every ``iteration``
span the matching ``round_breakdown`` event contributes the measured
segments (cohort_prep / h2d / dispatch / device_compute / writeback /
drift_decision / eval and the residual dispatch_gap), the dominant
segment is named per iteration and overall, and iterations whose wall
time stretches past the run median are attributed to the concrete cause
recorded in the event stream — the straggler clients that missed the
deadline (``straggler_masked``) or the edge that failed
(``edge_failed``) during that iteration; the port records neither yet.
Pure host-side: no torch, no device, safe to run while the run is still
writing.

The segment sums are checked against the iteration span's wall clock
(``coverage`` column); by construction the residual dispatch_gap closes
the budget, so a coverage far from 1.0 means the two streams disagree
(clock skew, truncated file) and the row is flagged.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

SEGMENT_ORDER = ("cohort_prep", "h2d", "dispatch", "device_compute",
                 "writeback", "drift_decision", "eval", "dispatch_gap")


def _load_jsonl(path: str) -> list[dict]:
    """Load a JSONL stream, oldest rotation generation first; a missing
    file is an empty stream and a truncated tail line is dropped."""
    out: list[dict] = []
    for p in (path + ".1", path):
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue   # mid-write tail of a live run
    return out


def load_run(run_dir: str) -> tuple[list[dict], list[dict]]:
    spans = _load_jsonl(os.path.join(run_dir, "spans.jsonl"))
    events = _load_jsonl(os.path.join(run_dir, "events.jsonl"))
    if not spans and not events:
        raise FileNotFoundError(
            f"{run_dir}: neither spans.jsonl nor events.jsonl found")
    return spans, events


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def analyze(run_dir: str) -> dict[str, Any]:
    """Per-iteration segment table + overall dominant-segment verdict."""
    spans, events = load_run(run_dir)
    iter_walls: dict[int, float] = {}
    for s in spans:
        if s.get("name") == "iteration":
            it = s.get("args", {}).get("iteration")
            if it is not None:
                # spans.jsonl stores ts/dur in microseconds (trace-event
                # convention, obs/spans.py)
                iter_walls[int(it)] = float(s.get("dur", 0.0)) / 1e6

    breakdowns: dict[int, dict] = {}
    culprits: dict[int, list[dict]] = {}
    for ev in events:
        it = ev.get("iteration")
        if it is None:
            continue
        it = int(it)
        kind = ev.get("kind")
        if kind == "round_breakdown":
            breakdowns[it] = ev
        elif kind == "straggler_masked":
            culprits.setdefault(it, []).append(
                {"cause": "straggler", "round": ev.get("part_round"),
                 "clients": ev.get("clients"),
                 "deadline_s": ev.get("deadline")})
        elif kind == "edge_failed":
            culprits.setdefault(it, []).append(
                {"cause": "edge_failed", "round": ev.get("fault_round"),
                 "edges": ev.get("edges"), "reason": ev.get("reason")})

    iterations: list[dict] = []
    totals: dict[str, float] = {}
    walls: list[float] = []
    for it in sorted(set(iter_walls) | set(breakdowns)):
        bd = breakdowns.get(it)
        wall = iter_walls.get(
            it, float(bd.get("wall_s", 0.0)) if bd else 0.0)
        segs = dict(bd.get("segments", {})) if bd else {}
        seg_sum = sum(segs.values())
        for k, v in segs.items():
            totals[k] = totals.get(k, 0.0) + v
        dominant = max(segs, key=segs.get) if segs else None
        iterations.append({
            "iteration": it,
            "wall_s": round(wall, 6),
            "segments": segs,
            "dominant": dominant,
            "coverage": round(seg_sum / wall, 4) if wall else None,
            "host_overhead_frac": bd.get("host_overhead_frac") if bd else None,
            "profiled_rounds": bd.get("profiled_rounds") if bd else None,
            "culprits": culprits.get(it, []),
        })
        if wall:
            walls.append(wall)

    # attribution: an iteration is "extended" when its wall runs past the
    # run median — name the recorded fault that stretched it, if any
    med = _median(walls)
    for row in iterations:
        row["extended"] = bool(med and row["wall_s"] > 1.25 * med)
        if row["extended"] and row["culprits"]:
            c = row["culprits"][0]
            if c["cause"] == "straggler":
                row["attribution"] = (
                    f"straggler client(s) {c.get('clients')} missed the "
                    f"{c.get('deadline_s')}s deadline in round "
                    f"{c.get('round')}")
            else:
                row["attribution"] = (
                    f"edge(s) {c.get('edges')} failed "
                    f"({c.get('reason')}) in round {c.get('round')}")
        elif row["extended"]:
            row["attribution"] = "no fault recorded (host-side variance)"

    overall_dominant = max(totals, key=totals.get) if totals else None
    hofs = [r["host_overhead_frac"] for r in iterations
            if r["host_overhead_frac"] is not None]
    return {
        "run_dir": run_dir,
        "iterations": iterations,
        "totals": {k: round(v, 6) for k, v in sorted(totals.items())},
        "dominant_segment": overall_dominant,
        "median_wall_s": round(med, 6),
        "host_overhead_frac_mean": (round(sum(hofs) / len(hofs), 6)
                                    if hofs else None),
    }


def render(result: dict[str, Any]) -> str:
    segs_present = [s for s in SEGMENT_ORDER if s in result["totals"]]
    segs_present += sorted(set(result["totals"]) - set(SEGMENT_ORDER))
    head = "iter " + " ".join(f"{s[:12]:>12}" for s in segs_present) \
        + f" {'wall':>9} {'cover':>6}  dominant"
    lines = [head, "-" * len(head)]
    for row in result["iterations"]:
        cells = " ".join(f"{row['segments'].get(s, 0.0):>12.4f}"
                         for s in segs_present)
        cover = (f"{row['coverage']:.2f}" if row["coverage"] is not None
                 else "-")
        lines.append(f"{row['iteration']:<4} {cells} {row['wall_s']:>9.3f} "
                     f"{cover:>6}  {row['dominant'] or '-'}")
        if row.get("attribution"):
            lines.append(f"     ^ extended iteration: {row['attribution']}")
    lines.append("")
    if result["dominant_segment"]:
        tot = result["totals"]
        dom = result["dominant_segment"]
        lines.append(
            f"critical path: {dom} dominates "
            f"({tot[dom]:.3f}s of {sum(tot.values()):.3f}s measured)")
    if result["host_overhead_frac_mean"] is not None:
        lines.append("host_overhead_frac (mean): "
                     f"{result['host_overhead_frac_mean']:.4f}")
    return "\n".join(lines)


def render_flame(run_dir: str, result: dict[str, Any],
                 top: int = 10) -> str:
    """The host-side view of the dominant segment: top-N folded stacks
    from the run's sampling profiler (``hostprof.folded``, written when
    ``cfg.hostprof_hz > 0``). A segment table says WHICH phase dominates;
    the flame rows say WHAT the host was executing during it."""
    path = os.path.join(run_dir, "hostprof.folded")
    if not os.path.exists(path):
        return ("no hostprof data: rerun with --hostprof_hz > 0 to sample "
                "host stacks (writes hostprof.folded next to spans.jsonl)")
    rows = []
    with open(path) as f:
        for line in f:
            stack, _, count = line.rstrip("\n").rpartition(" ")
            if stack and count.isdigit():
                rows.append((int(count), stack))
    if not rows:
        return "hostprof.folded is empty (profiler sampled no stacks)"
    rows.sort(key=lambda r: (-r[0], r[1]))
    total = sum(c for c, _ in rows)
    dom = result.get("dominant_segment") or "-"
    lines = [f"host stacks while '{dom}' dominated the critical path "
             f"({total} samples, top {min(top, len(rows))} of {len(rows)} "
             f"stacks):"]
    for count, stack in rows[:top]:
        # leaf-first: the sampled frame, then its callers
        frames = stack.split(";")
        lines.append(f"{count:>6} ({100.0 * count / total:5.1f}%)  "
                     f"{' <- '.join(reversed(frames[-4:]))}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="feddrift_torch critical_path",
        description="per-round critical-path breakdown + straggler/edge "
                    "attribution from a run dir's spans/events streams")
    ap.add_argument("run_dir")
    ap.add_argument("--json", action="store_true", help="machine-readable")
    ap.add_argument("--flame", action="store_true",
                    help="also print the top folded host stacks from the "
                         "run's sampling profiler (hostprof.folded)")
    ap.add_argument("--flame-top", type=int, default=10, metavar="N",
                    help="folded stacks to print with --flame (default 10)")
    args = ap.parse_args(argv)
    try:
        result = analyze(args.run_dir)
    except (OSError, FileNotFoundError) as e:
        print(f"critical_path: {e}", file=sys.stderr)
        return 2
    if not result["iterations"]:
        print(f"critical_path: {args.run_dir}: no iteration records",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(render(result))
    if args.flame:
        print()
        print(render_flame(args.run_dir, result, top=args.flame_top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
