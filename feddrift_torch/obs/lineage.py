"""Cluster lineage: the genealogy DAG + oracle scoring behind
``python -m feddrift_torch lineage <run_dir>``.

Copy of ``feddrift_tpu/obs/lineage.py``. The drift algorithms operate on
a fixed pool of MODEL SLOTS: a slot is created for a drifted client set,
absorbs another slot in a hierarchical merge, gets reset by FedDrift-C /
softclusterreset, is bipartitioned by CFL, and is REUSED once the LRU
allocator runs out of free slots. Raw ``cluster_*`` events therefore tell
a slot-indexed story in which "model 1" can be three different concepts
over a run. This module replays the event stream and resolves slot reuse
into stable LINEAGE IDS (``L0``, ``L1``, ...): one id per concept-model
incarnation, with create/merge/split/delete edges forming a genealogy
DAG.

The per-iteration ``cluster_assign`` events are the E-step's state, and
for synthetic datasets, whose ground-truth ``concept_matrix`` rides along
in the ``run_start`` event, the assignment timeline is scored with
per-iteration Adjusted Rand Index and cluster purity (``oracle
agreement``). ``adjusted_rand_index`` and ``cluster_purity`` are also what
``DriftAlgorithm.emit_assignment`` puts on every ``cluster_assign`` event.

Pure host-side: numpy + stdlib only. The event schema is the reference's,
so either package's ``lineage`` reads either package's run directory.

    python -m feddrift_torch lineage runs/sea-fnn-softcluster-H_A_C_1_10_0-s0
    python -m feddrift_torch lineage <run_dir> --dot lineage.dot --json
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

# Event kinds the genealogy replay consumes (a subset of
# obs.events.EVENT_KINDS; the lineage builder ignores everything else).
GENEALOGY_KINDS = ("cluster_create", "cluster_merge", "cluster_delete",
                   "cluster_split", "cluster_assign")


# ----------------------------------------------------------------------
# oracle agreement metrics (hand-rolled: the report/lineage CLI path must
# stay dependency-light, and the closed-form ARI is ~15 lines)
def adjusted_rand_index(labels_true, labels_pred) -> float:
    """Adjusted Rand Index between two labelings (permutation-invariant).

    Standard Hubert-Arabie form via the contingency table. Both inputs
    are label vectors of equal length; label values are arbitrary ids
    (cluster slots vs. concept ids). Two trivial single-cluster
    partitions agree perfectly (1.0) rather than 0/0."""
    a = np.asarray(labels_true).ravel()
    b = np.asarray(labels_pred).ravel()
    if a.size != b.size:
        raise ValueError(f"label length mismatch: {a.size} vs {b.size}")
    n = a.size
    if n == 0:
        return 0.0
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    cont = np.zeros((int(ai.max()) + 1, int(bi.max()) + 1), dtype=np.int64)
    np.add.at(cont, (ai, bi), 1)

    def comb2(x):
        x = np.asarray(x, dtype=np.float64)
        return x * (x - 1) / 2.0

    sum_ij = comb2(cont).sum()
    sum_a = comb2(cont.sum(axis=1)).sum()
    sum_b = comb2(cont.sum(axis=0)).sum()
    total = comb2(n)
    expected = sum_a * sum_b / total if total else 0.0
    max_index = (sum_a + sum_b) / 2.0
    if max_index == expected:        # both partitions trivial -> identical
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))


def cluster_purity(labels_true, labels_pred) -> float:
    """Fraction of points whose predicted cluster's majority true label
    matches their own: sum over predicted clusters of the dominant true
    count, / n. 1.0 = every cluster is concept-pure."""
    a = np.asarray(labels_true).ravel()
    b = np.asarray(labels_pred).ravel()
    if a.size != b.size:
        raise ValueError(f"label length mismatch: {a.size} vs {b.size}")
    if a.size == 0:
        return 0.0
    correct = 0
    for cl in np.unique(b):
        members = a[b == cl]
        _, counts = np.unique(members, return_counts=True)
        correct += int(counts.max())
    return float(correct / a.size)


# ----------------------------------------------------------------------
# genealogy reconstruction
@dataclass
class LineageNode:
    """One incarnation of a cluster model: a pool slot between its
    creation (or first sighting) and its end (merge/delete/split/reuse)."""
    lid: str                          # stable id: "L0", "L1", ...
    slot: int                         # pool slot it occupied
    start: Optional[int]              # iteration created/first seen
    origin: str                       # root | drift_spawn | split | create
    parents: list = field(default_factory=list)     # lineage ids
    evidence: dict = field(default_factory=dict)    # creation evidence
    end: Optional[int] = None         # iteration the lineage ended
    end_reason: Optional[str] = None  # merged_into:<lid> | deleted:<r> |
    #                                   split | slot_reused
    absorbed: list = field(default_factory=list)    # merges INTO this node:
    #                                   {lid, iteration, evidence}
    children: list = field(default_factory=list)    # spawn/split children

    def to_json(self) -> dict:
        return {
            "lid": self.lid, "slot": self.slot, "start": self.start,
            "origin": self.origin, "parents": self.parents,
            "evidence": self.evidence, "end": self.end,
            "end_reason": self.end_reason, "absorbed": self.absorbed,
            "children": self.children,
        }


class Lineage:
    """The replayed genealogy: nodes + the per-iteration assignment rows."""

    def __init__(self) -> None:
        self.nodes: list[LineageNode] = []
        self.by_id: dict[str, LineageNode] = {}
        self._current: dict[int, LineageNode] = {}   # slot -> open node
        self.assignments: dict[int, dict] = {}       # iteration -> last event
        self.meta: dict[str, Any] = {}               # run_start payload

    # -- construction ---------------------------------------------------
    def _new_node(self, slot: int, start: Optional[int], origin: str,
                  parents: list[str], evidence: dict) -> LineageNode:
        node = LineageNode(lid=f"L{len(self.nodes)}", slot=int(slot),
                           start=start, origin=origin, parents=list(parents),
                           evidence=dict(evidence))
        self.nodes.append(node)
        self.by_id[node.lid] = node
        self._current[int(slot)] = node
        for p in parents:
            self.by_id[p].children.append(node.lid)
        return node

    def _ensure(self, slot: int, it: Optional[int]) -> LineageNode:
        """Open lineage on ``slot``; a slot referenced before any create
        event is a root (e.g. model 0, or every slot under IFCA/'F' init)."""
        node = self._current.get(int(slot))
        if node is None:
            node = self._new_node(slot, it, "root", [], {})
        return node

    def _end(self, node: LineageNode, it: Optional[int],
             reason: str) -> None:
        node.end = it
        node.end_reason = reason
        if self._current.get(node.slot) is node:
            del self._current[node.slot]

    def open_nodes(self) -> list[LineageNode]:
        return [n for n in self.nodes if n.end_reason is None]

    def roots(self) -> list[LineageNode]:
        return [n for n in self.nodes if not n.parents]


def build_lineage(events: list[dict]) -> Lineage:
    """Replay the event stream into a Lineage. Order = file order (the
    bus appends under one lock, so this is emission order)."""
    lin = Lineage()
    for e in events:
        kind = e.get("kind")
        it = e.get("iteration")
        if kind == "run_start":
            lin.meta = {k: v for k, v in e.items()
                        if k not in ("_ts", "kind")}
        elif kind == "cluster_create":
            slot = int(e["model"])
            init_from = e.get("init_from")
            parents = []
            if init_from is not None:
                parents = [lin._ensure(int(init_from), it).lid]
            old = lin._current.get(slot)
            if old is not None:        # LRU slot reuse: old incarnation ends
                lin._end(old, it, "slot_reused")
            evidence = {k: e[k] for k in ("client", "clients", "init_from")
                        if e.get(k) is not None}
            lin._new_node(slot, it, "drift_spawn", parents, evidence)
        elif kind == "cluster_merge":
            base = lin._ensure(int(e["base"]), it)
            merged = lin._ensure(int(e["merged"]), it)
            evidence = {k: e[k] for k in ("distance", "threshold",
                                          "distance_row", "in_use")
                        if e.get(k) is not None}
            lin._end(merged, it, f"merged_into:{base.lid}")
            base.absorbed.append({"lid": merged.lid, "iteration": it,
                                  "evidence": evidence})
        elif kind == "cluster_delete":
            node = lin._current.get(int(e["model"]))
            if node is not None:
                lin._end(node, it, f"deleted:{e.get('reason', '?')}")
        elif kind == "cluster_split":
            old = lin._ensure(int(e["model"]), it)
            lin._end(old, it, "split")
            evidence = {k: e[k] for k in ("clients_kept", "clients_moved",
                                          "alpha_cross", "gamma")
                        if e.get(k) is not None}
            lin._new_node(e["model"], it, "split", [old.lid],
                          {**evidence, "side": "kept"})
            lin._new_node(e["new_model"], it, "split", [old.lid],
                          {**evidence, "side": "moved"})
        elif kind == "cluster_assign":
            if it is not None:
                for slot in set(e.get("assignment", ())):
                    lin._ensure(int(slot), it)
                lin.assignments[int(it)] = e
    return lin


# ----------------------------------------------------------------------
# oracle scoring of the assignment timeline
def concept_matrix_from_events(events: list[dict]) -> Optional[np.ndarray]:
    """[T1, C] ground-truth concept matrix, carried by run_start for
    synthetic datasets (None for runs that predate it / huge matrices)."""
    for e in events:
        if e.get("kind") == "run_start":
            cm = e.get("concept_matrix")
            if cm:
                return np.asarray(cm, dtype=np.int64)
            return None
    return None


def score_timeline(lin: Lineage,
                   concept_matrix: Optional[np.ndarray]) -> list[dict]:
    """One row per iteration with a cluster_assign event: the assignment
    vector, models in use, and — when ground truth is available — ARI +
    purity recomputed against the concept matrix (falling back to the
    oracle_* fields the algorithm embedded live)."""
    rows = []
    for it in sorted(lin.assignments):
        e = lin.assignments[it]
        assign = e.get("assignment") or []
        row: dict[str, Any] = {
            "iteration": it,
            "assignment": [int(a) for a in assign],
            "num_models": len(set(assign)),
        }
        if concept_matrix is not None and it < concept_matrix.shape[0] \
                and len(assign) == concept_matrix.shape[1]:
            truth = concept_matrix[it]
            row["ari"] = round(adjusted_rand_index(truth, assign), 4)
            row["purity"] = round(cluster_purity(truth, assign), 4)
        elif e.get("oracle_ari") is not None:
            row["ari"] = e["oracle_ari"]
            row["purity"] = e.get("oracle_purity")
        rows.append(row)
    return rows


def oracle_summary(rows: list[dict]) -> Optional[dict]:
    aris = [r["ari"] for r in rows if r.get("ari") is not None]
    if not aris:
        return None
    purities = [r["purity"] for r in rows if r.get("purity") is not None]
    return {
        "final_ari": aris[-1],
        "best_ari": max(aris),
        "mean_ari": round(float(np.mean(aris)), 4),
        "final_purity": purities[-1] if purities else None,
    }


# ----------------------------------------------------------------------
# rendering
def _node_line(n: LineageNode) -> str:
    start = f"@t{n.start}" if n.start is not None else "@t?"
    bits = [f"{n.lid} [slot {n.slot}] {n.origin} {start}"]
    ev = n.evidence
    if n.origin == "drift_spawn":
        who = ev.get("client", ev.get("clients"))
        src = f"init from slot {ev['init_from']}" if "init_from" in ev else ""
        trig = f"client {who}" if who is not None else ""
        detail = ", ".join(x for x in (trig, src) if x)
        if detail:
            bits.append(f"({detail})")
    elif n.origin == "split" and "side" in ev:
        detail = f"({ev['side']}"
        if ev.get("alpha_cross") is not None:
            detail += f", alpha_cross={ev['alpha_cross']}"
        bits.append(detail + ")")
    if n.end_reason:
        at = f" @t{n.end}" if n.end is not None else ""
        bits.append(f"— {n.end_reason}{at}")
    else:
        bits.append("— active")
    return " ".join(bits)


def _absorb_lines(n: LineageNode) -> list[str]:
    out = []
    for ab in n.absorbed:
        ev = ab.get("evidence") or {}
        line = f"⇐ absorbed {ab['lid']} @t{ab.get('iteration', '?')}"
        if ev.get("distance") is not None:
            line += f" (dist {ev['distance']}"
            if ev.get("threshold") is not None:
                line += f" ≤ Δ'={ev['threshold']}"
            line += ")"
        out.append(line)
    return out


def render_tree(lin: Lineage) -> str:
    """ASCII forest over spawn/split edges; merges annotate the absorbing
    node (the DAG's cross edges, which a tree cannot hold)."""
    n_merge = sum(len(n.absorbed) for n in lin.nodes)
    L = [f"cluster genealogy ({len(lin.nodes)} lineages, "
         f"{n_merge} merges, {len(lin.open_nodes())} active)"]

    def walk(node: LineageNode, prefix: str, tail: bool) -> None:
        branch = "└─ " if tail else "├─ "
        L.append(prefix + branch + _node_line(node))
        child_prefix = prefix + ("   " if tail else "│  ")
        extras = _absorb_lines(node)
        kids = [lin.by_id[c] for c in node.children]
        for x in extras:
            L.append(child_prefix + ("│  " if kids else "   ") + x)
        for i, k in enumerate(kids):
            walk(k, child_prefix, i == len(kids) - 1)

    roots = lin.roots()
    for i, r in enumerate(roots):
        L.append(_node_line(r))
        extras = _absorb_lines(r)
        kids = [lin.by_id[c] for c in r.children]
        for x in extras:
            L.append(("│  " if kids else "   ") + x)
        for j, k in enumerate(kids):
            walk(k, "", j == len(kids) - 1)
    if not roots:
        L.append("  (no cluster events recorded)")
    return "\n".join(L)


def render_timeline(rows: list[dict]) -> str:
    if not rows:
        return "assignment timeline: (no cluster_assign events recorded)"
    has_oracle = any(r.get("ari") is not None for r in rows)
    head = "  t   assignment (client → model)"
    if has_oracle:
        head += "  models  ARI      purity"
    else:
        head += "  models"
    L = ["assignment timeline:", head]
    width = max(len(" ".join(str(a) for a in r["assignment"]))
                for r in rows)
    for r in rows:
        vec = " ".join(str(a) for a in r["assignment"])
        line = f"  {r['iteration']:<3} [{vec:<{width}}]  {r['num_models']:>5}"
        if has_oracle:
            ari = r.get("ari")
            pur = r.get("purity")
            line += (f"  {ari:>7.4f}" if ari is not None else "        —")
            line += (f"  {pur:>6.4f}" if pur is not None else "       —")
        L.append(line)
    return "\n".join(L)


def to_dot(lin: Lineage) -> str:
    """Graphviz DOT of the full DAG: solid spawn/split edges, dashed merge
    (absorption) edges labeled with the winning distance."""
    L = ["digraph cluster_lineage {",
         "  rankdir=TB;",
         '  node [shape=box, fontname="monospace"];']
    for n in lin.nodes:
        start = f"t{n.start}" if n.start is not None else "t?"
        label = f"{n.lid}\\nslot {n.slot}\\n{n.origin} {start}"
        if n.end_reason:
            label += f"\\n{n.end_reason} t{n.end}"
        style = ', style=filled, fillcolor="#e8f4e8"' if not n.end_reason \
            else ""
        L.append(f'  {n.lid} [label="{label}"{style}];')
    for n in lin.nodes:
        for c in n.children:
            L.append(f"  {n.lid} -> {c};")
        for ab in n.absorbed:
            ev = ab.get("evidence") or {}
            lbl = f"merge t{ab.get('iteration', '?')}"
            if ev.get("distance") is not None:
                lbl += f"\\nd={ev['distance']}"
            L.append(f'  {ab["lid"]} -> {n.lid} '
                     f'[style=dashed, label="{lbl}"];')
    L.append("}")
    return "\n".join(L) + "\n"


# ----------------------------------------------------------------------
# entry points
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
                continue                 # tolerate a torn tail line
    return records


def summarize(run_dir: str) -> dict[str, Any]:
    """Machine-readable lineage summary (the --json output)."""
    events = _load_jsonl(os.path.join(run_dir, "events.jsonl"))
    lin = build_lineage(events)
    cm = concept_matrix_from_events(events)
    rows = score_timeline(lin, cm)
    return {
        "run_dir": run_dir,
        "has_events": bool(events),
        "meta": lin.meta,
        "nodes": [n.to_json() for n in lin.nodes],
        "timeline": rows,
        "oracle": oracle_summary(rows),
        "has_ground_truth": cm is not None,
    }


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="feddrift_torch lineage",
        description="reconstruct the cluster genealogy DAG from "
                    "events.jsonl, with oracle ARI/purity scoring for "
                    "synthetic ground truth")
    ap.add_argument("run_dir", help="run directory holding events.jsonl")
    ap.add_argument("--dot", metavar="PATH", default=None,
                    help="also write a Graphviz DOT export")
    ap.add_argument("--json", action="store_true", help="machine-readable")
    args = ap.parse_args(argv)

    import sys
    if not os.path.isdir(args.run_dir):
        print(f"lineage: run_dir {args.run_dir!r} does not exist",
              file=sys.stderr)
        return 1
    events_path = os.path.join(args.run_dir, "events.jsonl")
    events = _load_jsonl(events_path)
    if not events:
        print(f"lineage: {events_path} is missing or empty — the run "
              "predates the event bus or never started", file=sys.stderr)
        return 1

    lin = build_lineage(events)
    cm = concept_matrix_from_events(events)
    rows = score_timeline(lin, cm)

    if args.dot:
        with open(args.dot, "w") as f:
            f.write(to_dot(lin))

    if args.json:
        out = summarize(args.run_dir)
        if args.dot:
            out["dot"] = args.dot
        print(json.dumps(out, indent=2))
        return 0

    print(f"run: {args.run_dir}")
    meta = lin.meta
    if meta:
        print(f"  {meta.get('algo', '?')}/{meta.get('algo_arg', '?')} on "
              f"{meta.get('dataset', '?')} — {meta.get('clients', '?')} "
              f"clients, pool of {meta.get('num_models', '?')} models")
    print()
    print(render_tree(lin))
    print()
    print(render_timeline(rows))
    osum = oracle_summary(rows)
    if osum:
        print()
        print(f"oracle agreement (vs concept_matrix): "
              f"final ARI {osum['final_ari']:.4f}, "
              f"best {osum['best_ari']:.4f}, mean {osum['mean_ari']:.4f}"
              + (f", final purity {osum['final_purity']:.4f}"
                 if osum.get("final_purity") is not None else ""))
    elif cm is None:
        print()
        print("oracle agreement: unavailable (no concept_matrix in "
              "run_start — non-synthetic dataset or pre-lineage run)")
    if args.dot:
        print(f"\nDOT written: {args.dot}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
