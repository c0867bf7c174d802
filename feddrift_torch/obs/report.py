"""Render a human-readable run report from a run directory.

Copy of ``feddrift_tpu/obs/report.py``: consumes ``events.jsonl`` (the
structured event bus stream) plus ``metrics.jsonl`` (the scalar series)
and prints the phase breakdown, drift/cluster timeline, throughput,
fault and resilience summaries and final accuracy, from either package's
run directory:

    python -m feddrift_torch report runs/sea-fnn-softcluster-H_A_C_1_10_0-s0
    python -m feddrift_torch report --json <run_dir>
    python -m feddrift_torch report <run_dir> --trace    # + trace.json
    python -m feddrift_torch report <run_dir> --follow   # tail + alerts

Runs with only ``metrics.jsonl`` (the committed ``runs/*``) degrade
gracefully: the metrics-derived sections render, event-derived sections
report their absence. The cost-model section reads ``program_cost`` and
``hbm_watermark`` events; the port emits no ``program_cost`` yet, so its
roofline stays absent on port runs. Left out of the copy: the reference's
TPU datasheet peak lookup in the roofline (its ``flops_utilization`` and
``bandwidth_utilization``), which names TPU peaks only.
"""

from __future__ import annotations

import json
import os
from typing import Any

# Event kinds rendered on the drift/cluster timeline, in one place so the
# renderer and its tests agree.
TIMELINE_KINDS = ("drift_detected", "cluster_create", "cluster_merge",
                  "cluster_delete", "cluster_split", "model_replaced")
FAULT_KINDS = ("fault_injected", "client_killed", "client_revived",
               "failure_suspected")
RESILIENCE_KINDS = ("conn_reconnect", "publish_retry", "heartbeat_missed",
                    "chaos_injected", "preempt_checkpoint",
                    "divergence_detected", "checkpoint_corrupt")
ROBUSTNESS_KINDS = ("byzantine_injected", "robust_agg_applied",
                    "acc_stale_excluded", "quorum_revive")
HIERARCHY_KINDS = ("edge_aggregated", "edge_failed", "edge_rehomed",
                   "update_compressed", "compress_corrupt")


def _load_jsonl(path: str) -> list[dict]:
    records = []
    if not os.path.isfile(path):
        return records
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue                     # tolerate a torn tail line
    return records


def summarize(run_dir: str) -> dict[str, Any]:
    """Machine-readable run summary (the --json output and the renderer's
    single source)."""
    # rotated generation first (size-capped runs), then the live file —
    # same fold order as critical_path's loader
    events = (_load_jsonl(os.path.join(run_dir, "events.jsonl.1"))
              + _load_jsonl(os.path.join(run_dir, "events.jsonl")))
    metrics = _load_jsonl(os.path.join(run_dir, "metrics.jsonl"))

    out: dict[str, Any] = {
        "run_dir": run_dir,
        "has_events": bool(events),
        "has_metrics": bool(metrics),
    }

    # -- accuracy trajectory (metrics.jsonl) ---------------------------
    test = [(r.get("iteration", 0), r.get("round", 0), r["Test/Acc"])
            for r in metrics if "Test/Acc" in r]
    if test:
        per_iter: dict[int, float] = {}
        for it, _, acc in test:
            per_iter[it] = acc
        out["accuracy"] = {
            "final_test_acc": test[-1][2],
            "best_test_acc": max(a for _, _, a in test),
            "iterations": len(per_iter),
            "rounds": test[-1][1] + 1,
            "per_iteration": [round(per_iter[k], 4) for k in sorted(per_iter)],
        }

    # -- phase breakdown + throughput (iteration_end events) -----------
    ends = [e for e in events if e["kind"] == "iteration_end"]
    phases: dict[str, dict[str, float]] = {}
    for e in ends:
        for name, s in (e.get("phases") or {}).items():
            agg = phases.setdefault(name, {"total_s": 0.0, "count": 0})
            agg["total_s"] += s.get("total_s", 0.0)
            agg["count"] += s.get("count", 0)
    if phases:
        out["phases"] = {k: {"total_s": round(v["total_s"], 4),
                             "count": int(v["count"])}
                         for k, v in sorted(phases.items())}
    if ends:
        wall = sum(e.get("wall_s", 0.0) for e in ends)
        examples = sum(e.get("examples", 0) for e in ends)
        rounds = sum(e.get("rounds", 0) for e in ends)
        out["throughput"] = {
            "wall_s": round(wall, 3),
            "rounds": rounds,
            "rounds_per_s": round(rounds / wall, 3) if wall else None,
            "examples_per_s": round(examples / wall, 1) if wall else None,
        }
    elif len(test) > 1 and metrics:
        # metrics-only fallback: wall-clock between first/last logged rows
        ts = [r["_ts"] for r in metrics if "_ts" in r]
        if len(ts) > 1 and ts[-1] > ts[0]:
            out["throughput"] = {
                "wall_s": round(ts[-1] - ts[0], 3),
                "rounds": test[-1][1] + 1,
                "rounds_per_s": round((test[-1][1] + 1) / (ts[-1] - ts[0]), 3),
                "examples_per_s": None,
            }

    # -- drift / cluster timeline --------------------------------------
    timeline = [e for e in events if e["kind"] in TIMELINE_KINDS]
    out["timeline"] = timeline
    states = [e for e in events if e["kind"] == "cluster_state"]
    if states:
        out["model_count"] = {
            "per_iteration": [(e.get("iteration"), e.get("num_models"))
                              for e in states],
            "final": states[-1].get("num_models"),
        }

    # -- assignment matrix + oracle agreement (cluster_assign events,
    # obs/lineage.py; ground truth rides in run_start.concept_matrix) ----
    assigns: dict[int, dict] = {}
    for e in events:
        if e["kind"] == "cluster_assign" and e.get("iteration") is not None:
            assigns[int(e["iteration"])] = e          # last one per t wins
    if assigns:
        out["assignments"] = [
            {"iteration": it,
             "assignment": assigns[it].get("assignment"),
             "oracle_ari": assigns[it].get("oracle_ari"),
             "oracle_purity": assigns[it].get("oracle_purity")}
            for it in sorted(assigns)]
        aris = [a["oracle_ari"] for a in out["assignments"]
                if a["oracle_ari"] is not None]
        if aris:
            purs = [a["oracle_purity"] for a in out["assignments"]
                    if a["oracle_purity"] is not None]
            out["oracle"] = {
                "final_ari": aris[-1], "best_ari": max(aris),
                "mean_ari": round(sum(aris) / len(aris), 4),
                "final_purity": purs[-1] if purs else None,
            }

    # -- alerts (obs/alerts.py: alerts.jsonl or live alert_raised) -------
    alert_recs = _load_jsonl(os.path.join(run_dir, "alerts.jsonl")) \
        or [e for e in events if e["kind"] == "alert_raised"]
    if alert_recs:
        by_rule: dict[str, int] = {}
        for a in alert_recs:
            by_rule[a.get("rule", "?")] = by_rule.get(a.get("rule", "?"), 0) + 1
        out["alerts"] = {
            "count": len(alert_recs),
            "by_rule": by_rule,
            "last": alert_recs[-5:],
        }

    # -- model-quality plane (obs/quality.py, platform/canary.py) --------
    # live per-model accuracy on the read path + shadow canary verdicts
    mq = [e for e in events if e["kind"] == "model_quality"]
    drifts = [e for e in events if e["kind"] == "serve_drift_suspected"]
    starts = [e for e in events if e["kind"] == "canary_started"]
    verdicts = [e for e in events if e["kind"] == "canary_verdict"]
    if mq or drifts or starts or verdicts:
        q: dict[str, Any] = {}
        if mq:
            last = mq[-1]
            q["live"] = {
                "snapshots": len(mq),
                "labeled": last.get("labeled"),
                "missed": last.get("missed"),
                "window": last.get("window"),
                "accuracy": last.get("accuracy"),
                "mean_confidence": last.get("mean_confidence"),
                "mean_entropy": last.get("mean_entropy"),
                "ece": last.get("ece"),
                "per_model": last.get("per_model"),
            }
        if drifts:
            q["drift_suspected"] = {
                "count": len(drifts),
                "last_score": drifts[-1].get("score"),
                "last_iteration": drifts[-1].get("iteration"),
            }
        if starts or verdicts:
            q["canary"] = {
                "started": len(starts),
                "commits": sum(1 for v in verdicts
                               if v.get("verdict") == "commit"),
                "rollbacks": sum(1 for v in verdicts
                                 if v.get("verdict") == "rollback"),
                "verdicts": [
                    {k: v.get(k) for k in
                     ("verdict", "reason", "decided_by", "samples",
                      "live_acc", "shadow_acc", "acc_delta", "agreement",
                      "slots", "lineage_ids")}
                    for v in verdicts[-8:]],
            }
        out["quality"] = q

    # -- faults ---------------------------------------------------------
    faults = [e for e in events if e["kind"] in FAULT_KINDS]
    if faults:
        injected = [e for e in faults if e["kind"] == "fault_injected"]
        dropped: set[int] = set()
        for e in injected:
            dropped.update(e.get("clients", []))
        suspects = [e for e in faults if e["kind"] == "failure_suspected"]
        out["faults"] = {
            "injected_rounds": len(injected),
            "clients_ever_dropped": sorted(dropped),
            "kills": sum(1 for e in faults if e["kind"] == "client_killed"),
            "last_suspected": (suspects[-1].get("clients") if suspects
                               else []),
        }

    # -- participation ---------------------------------------------------
    # population-scale cohort rounds (platform/registry.py,
    # resilience/participation.py; docs/RESILIENCE.md Participation model)
    cohorts = [e for e in events if e["kind"] == "cohort_sampled"]
    stragglers = [e for e in events if e["kind"] == "straggler_masked"]
    degraded = [e for e in events if e["kind"] == "round_degraded"]
    joins = [e for e in events if e["kind"] == "client_join"]
    leaves = [e for e in events if e["kind"] == "client_leave"]
    if cohorts or stragglers or degraded or joins or leaves:
        part: dict[str, Any] = {}
        if cohorts:
            last = cohorts[-1]
            part["cohorts"] = {
                "iterations": len(cohorts),
                "population": last.get("population"),
                "slots": last.get("slots"),
                "active_final": last.get("active"),
                "mean_reliability_final": last.get("mean_reliability"),
            }
        if stragglers:
            masked: set[int] = set()
            for e in stragglers:
                masked.update(e.get("clients", []))
            part["stragglers"] = {
                "rounds": len(stragglers),
                "masked_total": sum(len(e.get("clients", []))
                                    for e in stragglers),
                "distinct_clients": len(masked),
            }
        if degraded:
            part["degraded_rounds"] = {
                "count": len(degraded),
                "quorum": degraded[-1].get("quorum"),
                "last_on_time": degraded[-1].get("on_time"),
            }
        if joins or leaves:
            part["churn"] = {
                "joins": sum(len(e.get("clients", [])) for e in joins),
                "leaves": sum(len(e.get("clients", [])) for e in leaves),
            }
        out["participation"] = part

    # -- resilience ------------------------------------------------------
    # transport healing / preemption / divergence / checkpoint integrity
    # (feddrift_torch/resilience/, docs/RESILIENCE.md)
    res_counts = {k: sum(1 for e in events if e["kind"] == k)
                  for k in RESILIENCE_KINDS}
    if any(res_counts.values()):
        res: dict[str, Any] = {k: v for k, v in res_counts.items() if v}
        div = [e for e in events if e["kind"] == "divergence_detected"]
        if div:
            res["divergence_reasons"] = sorted(
                {e.get("reason", "?") for e in div})
        pre = [e for e in events if e["kind"] == "preempt_checkpoint"]
        if pre:
            res["preempted_at_iteration"] = pre[-1].get("iteration")
        out["resilience"] = res

    # -- robustness ------------------------------------------------------
    # adversary schedule / robust aggregation / staleness exclusions
    # (platform/faults.py::ByzantineInjector, resilience/robust_agg.py)
    byz = [e for e in events if e["kind"] == "byzantine_injected"]
    ragg = [e for e in events if e["kind"] == "robust_agg_applied"]
    stale = [e for e in events if e["kind"] == "acc_stale_excluded"]
    qrev = [e for e in events if e["kind"] == "quorum_revive"]
    if byz or ragg or stale or qrev:
        rob: dict[str, Any] = {}
        if byz:
            attackers: set[int] = set()
            for e in byz:
                attackers.update(e.get("clients", []))
            rob["byzantine"] = {
                "rounds": len(byz),
                "clients": sorted(attackers),
                "modes": sorted({e.get("mode", "?") for e in byz}),
            }
        if ragg:
            rob["aggregation"] = {
                "strategy": ragg[-1].get("strategy"),
                "rounds": len(ragg),
                "rejected_total": sum(e.get("rejected", 0) for e in ragg),
                "clipped_total": sum(e.get("clipped", 0) for e in ragg),
            }
        if stale:
            rob["stale_exclusions"] = {
                "events": len(stale),
                "decisions": sorted({e.get("decision", "?") for e in stale}),
                "changed_decisions": sum(1 for e in stale if e.get("changed")),
            }
        if qrev:
            rob["quorum_revives"] = len(qrev)
        out["robustness"] = rob

    # -- hierarchy --------------------------------------------------------
    # two-tier edge aggregation + wire compression
    # (platform/hierarchical.py, comm/compress.py; docs/RESILIENCE.md
    # Hierarchical aggregation)
    eagg = [e for e in events if e["kind"] == "edge_aggregated"]
    efail = [e for e in events if e["kind"] == "edge_failed"]
    ereh = [e for e in events if e["kind"] == "edge_rehomed"]
    comp_ev = [e for e in events if e["kind"] == "update_compressed"]
    corrupt = [e for e in events if e["kind"] == "compress_corrupt"]
    if eagg or efail or ereh or comp_ev or corrupt:
        hier: dict[str, Any] = {}
        if eagg:
            last = eagg[-1]
            hier["tiers"] = {
                "rounds": len(eagg),
                "edges": len(last.get("edge_active") or []),
                "edge_strategy": last.get("edge_strategy"),
                "server_strategy": last.get("server_strategy"),
                "edge_rejected_total": sum(e.get("edge_rejected", 0)
                                           for e in eagg),
                "server_rejected_total": sum(e.get("server_rejected", 0)
                                             for e in eagg),
            }
        if efail:
            by_reason: dict[str, int] = {}
            for e in efail:
                r = e.get("reason", "?")
                by_reason[r] = by_reason.get(r, 0) + 1
            hier["edge_failures"] = {"count": len(efail),
                                     "by_reason": by_reason}
        if ereh:
            hier["rehomed"] = {
                "events": len(ereh),
                "clients_total": sum(len(e.get("clients", []))
                                     for e in ereh),
                "last": {"edge": ereh[-1].get("edge"),
                         "targets": ereh[-1].get("targets")},
            }
        if comp_ev:
            by_codec: dict[str, dict[str, int]] = {}
            for e in comp_ev:
                d = by_codec.setdefault(e.get("codec", "?"),
                                        {"frames": 0, "raw_bytes": 0,
                                         "wire_bytes": 0})
                d["frames"] += 1
                d["raw_bytes"] += e.get("raw_bytes", 0)
                d["wire_bytes"] += e.get("wire_bytes", 0)
            hier["compression"] = {
                c: {**d, "ratio": round(d["raw_bytes"]
                                        / max(d["wire_bytes"], 1), 2)}
                for c, d in by_codec.items()}
        if corrupt:
            hier["corrupt_frames"] = len(corrupt)
        out["hierarchy"] = hier

    # -- secure aggregation (resilience/secure_round.py) ------------------
    sec_started = [e for e in events if e["kind"] == "secure_round_started"]
    sec_rec = [e for e in events if e["kind"] == "secure_reconstructed"]
    sec_deg = [e for e in events if e["kind"] == "secure_degraded"]
    sec_drop = [e for e in events if e["kind"] == "share_dropped"]
    if sec_started or sec_rec or sec_deg:
        modes = sorted({e.get("mode", "?") for e in sec_started})
        drop_by_reason: dict[str, int] = {}
        for e in sec_drop:
            r = e.get("reason", "?")
            drop_by_reason[r] = drop_by_reason.get(r, 0) + int(
                e.get("count", 1))
        sec: dict[str, Any] = {
            "rounds": len(sec_started),
            "modes": modes,
            "reconstructed": len(sec_rec),
            "degraded": len(sec_deg),
        }
        if sec_started:
            sec["threshold"] = sec_started[-1].get("threshold")
            sec["holders"] = sec_started[-1].get("holders")
        if sec_rec:
            sec["max_abs_err"] = max(e.get("max_abs_err", 0.0)
                                     for e in sec_rec)
            sec["min_holders_alive"] = min(e.get("holders_alive", 0)
                                           for e in sec_rec)
        if drop_by_reason:
            sec["shares_dropped"] = drop_by_reason
        if sec_deg:
            deg_reasons: dict[str, int] = {}
            for e in sec_deg:
                r = e.get("reason", "?")
                deg_reasons[r] = deg_reasons.get(r, 0) + 1
            sec["degrade_reasons"] = deg_reasons
        out["secure_agg"] = sec

    # -- cost model (obs/costmodel.py) -----------------------------------
    # XLA's own accounting per compiled program + live HBM watermarks
    prog_costs = [e for e in events if e["kind"] == "program_cost"]
    marks = [e for e in events if e["kind"] == "hbm_watermark"]
    profiles = [e for e in events if e["kind"] == "profile_captured"]
    if prog_costs or marks or profiles:
        cm: dict[str, Any] = {}
        if prog_costs:
            cm["programs"] = {
                e.get("fn", "?"): {k: e[k] for k in
                                   ("level", "flops", "bytes_accessed",
                                    "argument_bytes", "temp_bytes",
                                    "peak_hbm_bytes") if e.get(k) is not None}
                for e in prog_costs}
        peaks = [e["peak_hbm_bytes"] for e in prog_costs
                 if e.get("peak_hbm_bytes") is not None]
        peaks += [e["peak_bytes"] for e in marks
                  if e.get("peak_bytes") is not None]
        if peaks:
            cm["hbm_peak_bytes"] = max(peaks)
        if marks:
            cm["hbm_watermarks"] = len(marks)
        if profiles:
            cm["profiles_captured"] = sorted(
                {e.get("trace_dir", "?") for e in profiles})
        roof = _roofline_from_events(events, prog_costs, ends)
        if roof:
            cm["roofline"] = roof
        out["cost_model"] = cm

    # -- compiles --------------------------------------------------------
    compiles = [e for e in events if e["kind"] in ("jit_compile",
                                                   "jit_recompile")]
    if compiles:
        by_fn: dict[str, dict[str, int]] = {}
        for e in compiles:
            d = by_fn.setdefault(e.get("fn", "?"),
                                 {"compiles": 0, "recompiles": 0})
            d["compiles" if e["kind"] == "jit_compile" else "recompiles"] += 1
        out["compiles"] = by_fn

    return out


def _roofline_from_events(events: list[dict], prog_costs: list[dict],
                          ends: list[dict]) -> dict[str, Any] | None:
    """Achieved FLOP/s and bytes/s of the run from the captured round
    program's cost + the iteration walls (no utilization: the reference's
    TPU peak lookup is not copied)."""
    if not prog_costs or not ends:
        return None
    by_fn = {e.get("fn"): e for e in prog_costs}
    pc = by_fn.get("train_iteration_eval") or by_fn.get("train_round")
    if not pc or not pc.get("flops"):
        return None
    wall = sum(e.get("wall_s", 0.0) for e in ends)
    rounds = sum(e.get("rounds", 0) for e in ends)
    if wall <= 0 or not rounds:
        return None
    per_dispatch = max(rounds / len(ends), 1) \
        if pc["fn"] == "train_iteration_eval" else 1   # fused: R rounds/call
    flops_pr = pc["flops"] / per_dispatch
    bytes_pr = (pc.get("bytes_accessed") or 0) / per_dispatch
    out: dict[str, Any] = {
        "program": pc["fn"], "source": "cost_analysis",
        "flops_per_round": round(flops_pr, 1),
        "achieved_flops_per_s": round(flops_pr * rounds / wall, 1)}
    if bytes_pr:
        out["achieved_bytes_per_s"] = round(bytes_pr * rounds / wall, 1)
    return out


def _fmt_event(e: dict) -> str:
    skip = {"_ts", "kind", "iteration", "round"}
    detail = ", ".join(f"{k}={v}" for k, v in e.items() if k not in skip)
    where = f"t={e.get('iteration', '?')}"
    if "round" in e:
        where += f" r={e['round']}"
    return f"  {where:<12} {e['kind']:<16} {detail}"


def render(summary: dict[str, Any]) -> str:
    """The human-readable report, one section per telemetry dimension."""
    L: list[str] = [f"run: {summary['run_dir']}"]

    acc = summary.get("accuracy")
    if acc:
        L.append(f"  Test/Acc final={acc['final_test_acc']:.4f} "
                 f"best={acc['best_test_acc']:.4f} "
                 f"({acc['iterations']} iterations, {acc['rounds']} rounds)")
        traj = ", ".join(f"{a:.3f}" for a in acc["per_iteration"])
        L.append(f"  per-iteration: {traj}")
    elif not summary.get("has_metrics"):
        L.append("  (no metrics.jsonl)")

    tp = summary.get("throughput")
    L.append("")
    L.append("throughput:")
    if tp:
        ex = (f", {tp['examples_per_s']} examples/s"
              if tp.get("examples_per_s") else "")
        L.append(f"  {tp['rounds']} rounds in {tp['wall_s']}s "
                 f"= {tp['rounds_per_s']} rounds/s{ex}")
    else:
        L.append("  (unavailable — run predates events.jsonl)")

    L.append("")
    L.append("phase breakdown:")
    phases = summary.get("phases")
    if phases:
        total = sum(v["total_s"] for v in phases.values()) or 1.0
        for name, v in sorted(phases.items(), key=lambda kv: -kv[1]["total_s"]):
            L.append(f"  {name:<14} {v['total_s']:>9.3f}s "
                     f"({100 * v['total_s'] / total:5.1f}%)  n={v['count']}")
    else:
        L.append("  (unavailable — run predates events.jsonl)")

    L.append("")
    mc = summary.get("model_count")
    timeline = summary.get("timeline") or []
    L.append("drift/cluster timeline:")
    if mc:
        L.append(f"  models in use, final: {mc['final']}")
    if timeline:
        L.extend(_fmt_event(e) for e in timeline)
    elif not mc:
        L.append("  (no drift/cluster events recorded)")

    assigns = summary.get("assignments")
    if assigns:
        has_oracle = any(a.get("oracle_ari") is not None for a in assigns)
        head = "  assignment matrix (client → model"
        head += ", oracle ARI/purity):" if has_oracle else "):"
        L.append(head)
        shown = assigns if len(assigns) <= 40 else assigns[:39]
        for a in shown:
            vec = " ".join(str(v) for v in (a.get("assignment") or []))
            line = f"    t={a['iteration']:<3} [{vec}]"
            if a.get("oracle_ari") is not None:
                line += f"  ARI={a['oracle_ari']:.3f}"
            if a.get("oracle_purity") is not None:
                line += f" purity={a['oracle_purity']:.3f}"
            L.append(line)
        if len(assigns) > 40:
            L.append(f"    ... ({len(assigns) - 39} more iterations — "
                     "see `lineage` for the full timeline)")
        osum = summary.get("oracle")
        if osum:
            L.append(f"  oracle agreement: final ARI {osum['final_ari']:.4f} "
                     f"(best {osum['best_ari']:.4f}, "
                     f"mean {osum['mean_ari']:.4f})")

    q = summary.get("quality")
    if q:
        L.append("")
        L.append("quality:")
        lv = q.get("live")
        if lv:
            acc = lv.get("accuracy")
            line = (f"  live accuracy "
                    f"{'-' if acc is None else format(acc, '.4f')} "
                    f"(window {lv['window']}, labeled {lv['labeled']}, "
                    f"missed {lv['missed']}")
            if lv.get("ece") is not None:
                line += f", ECE {lv['ece']:.3f}"
            if lv.get("mean_entropy") is not None:
                line += f", entropy {lv['mean_entropy']:.3f}"
            L.append(line + ")")
            pm = lv.get("per_model") or {}
            bits = [f"m{m}={d['accuracy']:.3f}(n={d['n']})"
                    for m, d in sorted(pm.items()) if d]
            if bits:
                L.append(f"  per-model: {', '.join(bits)}")
        dr = q.get("drift_suspected")
        if dr:
            L.append(f"  serve drift suspected: {dr['count']}x "
                     f"(last KS score {dr['last_score']})")
        cn = q.get("canary")
        if cn:
            L.append(f"  canaries: {cn['started']} started, "
                     f"{cn['commits']} committed, "
                     f"{cn['rollbacks']} rolled back")
            for v in cn.get("verdicts") or []:
                lids = "<-".join(str(x) for x in (v.get("lineage_ids")
                                                  or [])) or "?"
                delta = v.get("acc_delta")
                why = (f"shadow acc {delta:+} over {v.get('samples')} labels"
                       if delta is not None else "no label evidence")
                L.append(f"    {v.get('reason', '?')} {lids} -> "
                         f"{v.get('verdict', '?')} ({why}, "
                         f"by {v.get('decided_by')})")

    faults = summary.get("faults")
    L.append("")
    L.append("faults:")
    if faults:
        L.append(f"  {faults['injected_rounds']} rounds with injected "
                 f"dropout; clients ever dropped: "
                 f"{faults['clients_ever_dropped']}; "
                 f"kills: {faults['kills']}; "
                 f"suspected now: {faults['last_suspected']}")
    else:
        L.append("  none recorded")

    part = summary.get("participation")
    if part:
        L.append("")
        L.append("participation:")
        co = part.get("cohorts")
        if co:
            L.append(f"  cohorts: {co['iterations']} iterations x "
                     f"{co['slots']} slots over population "
                     f"{co['population']} (active at end: "
                     f"{co['active_final']}, mean reliability "
                     f"{co['mean_reliability_final']})")
        st = part.get("stragglers")
        if st:
            L.append(f"  stragglers: {st['masked_total']} masked across "
                     f"{st['rounds']} rounds "
                     f"({st['distinct_clients']} distinct clients)")
        dg = part.get("degraded_rounds")
        if dg:
            L.append(f"  degraded rounds: {dg['count']} (quorum "
                     f"{dg['quorum']}, last on-time {dg['last_on_time']}) "
                     "— params kept, see quorum_miss alerts")
        ch = part.get("churn")
        if ch:
            L.append(f"  churn: {ch['joins']} joins, {ch['leaves']} leaves")

    res = summary.get("resilience")
    if res:
        L.append("")
        L.append("resilience:")
        counts = ", ".join(f"{k}={v}" for k, v in sorted(res.items())
                           if k in RESILIENCE_KINDS)
        L.append(f"  {counts}")
        if "divergence_reasons" in res:
            L.append(f"  divergence reasons: {res['divergence_reasons']}")
        if "preempted_at_iteration" in res:
            L.append(f"  preempted at iteration "
                     f"{res['preempted_at_iteration']} (resumable)")

    rob = summary.get("robustness")
    if rob:
        L.append("")
        L.append("robustness:")
        b = rob.get("byzantine")
        if b:
            L.append(f"  byzantine: {b['rounds']} attacked rounds, "
                     f"clients {b['clients']}, modes {b['modes']}")
        a = rob.get("aggregation")
        if a:
            L.append(f"  robust agg: {a['strategy']} over {a['rounds']} "
                     f"rounds, rejected={a['rejected_total']} "
                     f"clipped={a['clipped_total']}")
        s = rob.get("stale_exclusions")
        if s:
            L.append(f"  stale acc exclusions: {s['events']} "
                     f"({s['changed_decisions']} changed a decision; "
                     f"decisions: {s['decisions']})")
        if rob.get("quorum_revives"):
            L.append(f"  quorum revives: {rob['quorum_revives']}")

    hier = summary.get("hierarchy")
    if hier:
        L.append("")
        L.append("hierarchy:")
        ti = hier.get("tiers")
        if ti:
            L.append(f"  two-tier rounds: {ti['rounds']} over "
                     f"{ti['edges']} edges (edge={ti['edge_strategy']}, "
                     f"server={ti['server_strategy']}); rejected "
                     f"edge={ti['edge_rejected_total']} "
                     f"server={ti['server_rejected_total']}")
        ef = hier.get("edge_failures")
        if ef:
            reasons = ", ".join(f"{r}×{n}"
                                for r, n in sorted(ef["by_reason"].items()))
            L.append(f"  edge failures: {ef['count']} ({reasons})")
        rh = hier.get("rehomed")
        if rh:
            L.append(f"  re-homed: {rh['clients_total']} clients across "
                     f"{rh['events']} events (last: edge "
                     f"{rh['last']['edge']} → {rh['last']['targets']})")
        for codec, d in sorted((hier.get("compression") or {}).items()):
            L.append(f"  wire {codec}: {d['frames']} frames, "
                     f"{d['raw_bytes']} → {d['wire_bytes']} bytes "
                     f"({d['ratio']}x)")
        if hier.get("corrupt_frames"):
            L.append(f"  corrupt frames detected: {hier['corrupt_frames']} "
                     "(nacked, re-sent uncompressed)")

    sec = summary.get("secure_agg")
    if sec:
        L.append("")
        L.append("secure_agg:")
        L.append(f"  {sec['rounds']} secure rounds "
                 f"({', '.join(sec['modes'])}): "
                 f"{sec['reconstructed']} reconstructed, "
                 f"{sec['degraded']} degraded "
                 f"(T={sec.get('threshold', '?')}, "
                 f"holders={sec.get('holders', '?')})")
        if "max_abs_err" in sec:
            L.append(f"  quantization err vs plaintext: "
                     f"max {sec['max_abs_err']:.3g}; min holders alive "
                     f"{sec['min_holders_alive']}")
        if sec.get("shares_dropped"):
            reasons = ", ".join(
                f"{r}×{n}" for r, n in sorted(sec["shares_dropped"].items()))
            L.append(f"  shares dropped: {reasons}")
        if sec.get("degrade_reasons"):
            reasons = ", ".join(
                f"{r}×{n}" for r, n in sorted(sec["degrade_reasons"].items()))
            L.append(f"  degrade reasons: {reasons} (prev params kept)")

    al = summary.get("alerts")
    if al:
        L.append("")
        L.append("alerts:")
        rules = ", ".join(f"{r}×{n}" for r, n in sorted(al["by_rule"].items()))
        L.append(f"  {al['count']} raised — {rules}")
        for a in al["last"]:
            where = f"t={a.get('iteration', '?')}"
            L.append(f"  {where:<6} [{a.get('severity', '?')}] "
                     f"{a.get('rule', '?')}: {a.get('message', '')}")

    comp = summary.get("compiles")
    if comp:
        L.append("")
        L.append("XLA programs:")
        for fn, d in sorted(comp.items()):
            L.append(f"  {fn:<24} compiles={d['compiles']} "
                     f"recompiles={d['recompiles']}")

    cm = summary.get("cost_model")
    if cm:
        L.append("")
        L.append("cost model (XLA accounting):")
        for fn, d in sorted((cm.get("programs") or {}).items()):
            bits = []
            if d.get("flops") is not None:
                bits.append(f"{d['flops'] / 1e6:.1f} MFLOP")
            if d.get("bytes_accessed") is not None:
                bits.append(f"{d['bytes_accessed'] / 1e6:.1f} MB accessed")
            if d.get("peak_hbm_bytes") is not None:
                bits.append(f"peak {d['peak_hbm_bytes'] / 1e6:.1f} MB")
            L.append(f"  {fn:<24} {', '.join(bits) or d.get('level', '?')}")
        if cm.get("hbm_peak_bytes") is not None:
            n = f" ({cm['hbm_watermarks']} live watermarks)" \
                if cm.get("hbm_watermarks") else ""
            L.append(f"  peak HBM: {cm['hbm_peak_bytes'] / 1e6:.1f} MB{n}")
        roof = cm.get("roofline")
        if roof:
            line = (f"  roofline ({roof['program']}): "
                    f"{roof['achieved_flops_per_s'] / 1e9:.3f} GFLOP/s")
            if roof.get("achieved_bytes_per_s"):
                line += f", {roof['achieved_bytes_per_s'] / 1e9:.3f} GB/s"
            if roof.get("flops_utilization") is not None:
                line += (f" — {100 * roof['flops_utilization']:.2f}% of "
                         f"{roof.get('peak_source', 'peak')}")
            L.append(line)
        if cm.get("profiles_captured"):
            L.append(f"  profiler traces: {cm['profiles_captured']}")
    return "\n".join(L)


def follow(run_dir: str, timeout_s: float = 30.0, poll_s: float = 0.5,
           out=None) -> int:
    """Bounded tail mode: stream events.jsonl as it grows, print notable
    events (every alert_raised, plus offline rule evaluation via
    obs/alerts.py for runs recorded without live alerting), and render
    the ordinary report once the run ends — or the time bound expires.

    Returns 0; being cut off by the bound is the contract, not an error.
    """
    import sys
    import time as _time

    from feddrift_torch.obs import alerts as obs_alerts

    out = out or sys.stdout
    path = os.path.join(run_dir, "events.jsonl")
    gen1 = path + ".1"
    mon = obs_alerts.AlertMonitor()          # offline: no file, no bus
    seen_alerts: set = set()                 # (rule, iteration) dedupe
    offset = 0
    deadline = _time.monotonic() + timeout_s
    done = False

    def fmt_alert(a: dict, origin: str) -> str:
        return (f"[{origin}] t={a.get('iteration', '?')} "
                f"{a.get('severity', '?')}/{a.get('rule', '?')}: "
                f"{a.get('message', '')}")

    def read_from(p: str, start: int) -> tuple[list, int]:
        """Read whole JSON lines from byte ``start``; a torn tail line is
        left unconsumed (re-read next poll)."""
        recs = []
        with open(p) as f:
            f.seek(start)
            chunk = f.read()
            end = f.tell()
        for line in chunk.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                end -= len(line) + 1          # torn tail: re-read next poll
                break
        return recs, end

    print(f"following {path} (bound {timeout_s:.0f}s; "
          "ends at run_end)", file=out)
    # Fold an already-rotated generation first (size-capped runs —
    # obs_max_file_mb — move history to events.jsonl.1), like the other
    # readers (summarize/critical_path) do.
    pre_rotated: list = []
    if os.path.isfile(gen1):
        pre_rotated, _ = read_from(gen1, 0)
        print(f"(folded {len(pre_rotated)} events from rotated "
              f"{os.path.basename(gen1)})", file=out)
    while not done and _time.monotonic() < deadline:
        new, pre_rotated = pre_rotated, []
        if os.path.isfile(path):
            if os.path.getsize(path) < offset:
                # The file shrank below our offset: it rotated mid-follow
                # and our unread tail now lives in events.jsonl.1 — fold
                # it from the old offset instead of silently losing it.
                folded = []
                if os.path.isfile(gen1) and os.path.getsize(gen1) >= offset:
                    folded, _ = read_from(gen1, offset)
                new.extend(folded)
                print(f"(events.jsonl rotated mid-follow; folded "
                      f"{len(folded)} tail events from "
                      f"{os.path.basename(gen1)})", file=out)
                offset = 0
            recs, offset = read_from(path, offset)
            new.extend(recs)
        for e in new:
            kind = e.get("kind")
            if kind == "alert_raised":
                seen_alerts.add((e.get("rule"), e.get("iteration")))
                print(fmt_alert(e, "live"), file=out)
            else:
                n_before = len(mon.alerts)
                mon.observe(e)
                for a in mon.alerts[n_before:]:
                    key = (a.get("rule"), a.get("iteration"))
                    if key not in seen_alerts:
                        seen_alerts.add(key)
                        print(fmt_alert(a, "offline"), file=out)
            if kind == "iteration_end":
                print(f"t={e.get('iteration', '?')} done: "
                      f"Test/Acc={e.get('test_acc')} "
                      f"({e.get('rounds_per_s')} rounds/s)", file=out)
            if kind == "run_end":
                done = True
        if not done:
            _time.sleep(poll_s)

    print("", file=out)
    if not done:
        print(f"(bound reached after {timeout_s:.0f}s — report below is a "
              "snapshot of an unfinished run)", file=out)
    print(render(summarize(run_dir)), file=out)
    return 0


def main(argv: list[str] | None = None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="feddrift_torch report",
        description="render a run report from events.jsonl + metrics.jsonl")
    ap.add_argument("run_dirs", nargs="+", help="run directories")
    ap.add_argument("--json", action="store_true", help="machine-readable")
    ap.add_argument("--trace", action="store_true",
                    help="also write <run_dir>/trace.json (Chrome-trace-"
                         "event timeline from spans.jsonl + events.jsonl)")
    ap.add_argument("--follow", action="store_true",
                    help="bounded tail mode: stream events + alerts until "
                         "run_end or --follow-timeout, then render the "
                         "report")
    ap.add_argument("--follow-timeout", type=float, default=30.0,
                    help="max seconds to follow (default 30)")
    ap.add_argument("--poll", type=float, default=0.5,
                    help="follow-mode poll interval in seconds")
    args = ap.parse_args(argv)

    for d in args.run_dirs:
        if not os.path.isdir(d):
            print(f"report: run_dir {d!r} does not exist", file=sys.stderr)
            return 1

    if args.follow:
        if len(args.run_dirs) != 1:
            print("report: --follow takes exactly one run_dir",
                  file=sys.stderr)
            return 1
        return follow(args.run_dirs[0], timeout_s=args.follow_timeout,
                      poll_s=args.poll)

    summaries = []
    for d in args.run_dirs:
        s = summarize(d)
        if not s["has_metrics"] and not s["has_events"]:
            print(f"report: {d}: no metrics.jsonl or events.jsonl — "
                  "nothing to report (is this a run directory?)",
                  file=sys.stderr)
            return 1
        if args.trace:
            from feddrift_torch.obs import spans
            path = spans.write_trace(d)
            with open(path) as f:
                n = len(json.load(f)["traceEvents"])
            s["trace"] = {"path": path, "events": n}
            print(f"trace written: {path} ({n} events)")
        summaries.append(s)

    if args.json:
        print(json.dumps(summaries if len(summaries) > 1 else summaries[0],
                         indent=2))
        return 0
    print("\n\n".join(render(s) for s in summaries))
    return 0
