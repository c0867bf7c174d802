"""Two checkouts of the PyTorch port on one card, in turns: the same
training runs driven through ``Experiment`` in each, so that a change's
wall and device time are compared within one call.

    python3 scripts/torch_ab_runs.py --base DIR
                                     [--runs canonical,win-1,cfl,aue,kue]
                                     [--repeat K]

``DIR`` is a second checkout of the repository (for example the parent
commit unpacked with ``git archive``); the checkout this script lives in is
the other side. Four child processes run in turns, base, this, this, base.
Each imports ``feddrift_torch`` from its side's checkout (and builds that
side's kernels there) and, for every run named, makes one untimed warm-up
run, one timed run (the host clock around ``Experiment.run`` and a
synchronise), with the host seconds of the runner's round segments
summed over its steps (``round_breakdown`` events: ``dispatch`` is the
host's calls into ``train_round`` / ``train_iteration_eval``,
``device_compute`` the waits for the card: a fused step's one, the
per-round path's every ``profile_rounds``-th round),
and one more time step under torch.profiler on the path the run's last
step took: kernel launches a round, device time a round and the busy
share, and each kernel's launches. ``--repeat K`` runs the four turns K times. Each child prints one
``ab_run`` JSON line per run; then one ``ab`` line per run gives both
sides' walls, segments and profiles and whether the two sides' Test/Acc
series and final pools are bitwise equal. Runs use the
canonical configuration (SEA, change points A, 10 clients, 10 steps of 200
rounds) with the algorithm named and no checkpoints. Exits non-zero if a
child failed. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

# run name -> (concept_drift_algo, concept_drift_algo_arg)
RUNS = {"canonical": ("softcluster", "H_A_C_1_10_0"),
        "win-1": ("win-1", "H_A_C_1_10_0"),
        "cfl": ("softcluster", "cfl_0.1_win-1"),
        "aue": ("aue", "H_A_C_1_10_0"),
        "kue": ("kue", "H_A_C_1_10_0")}
ORDER = ("base", "this", "this", "base")


def _profile_step(exp) -> dict:
    """One more time step of a finished run under torch.profiler, on the
    path its last step took: the step alone (no copy of the state inside
    the window), with each kernel's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    T, R = exp.cfg.train_iterations, exp.cfg.comm_round
    opt = exp.step.init_opt_states(exp.pool.params, exp.pool.num_models,
                                   exp.C_)
    fused = exp.cfg.chunk_rounds and exp.algo.chunkable(T - 1)
    run = exp._run_iteration_fused if fused else exp._run_rounds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(T - 1, opt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    by_kernel = {}          # kernels of one template family add up
    for e in kernels:
        by_kernel[e.key[:60]] = by_kernel.get(e.key[:60], 0) + e.count
    return {"path": "fused" if fused else "per_round",
            "launches_per_round": sum(e.count for e in kernels) / R,
            "device_ms_per_round": busy_us / R / 1e3 if busy_us
            else "not measured",
            "device_busy_share": busy_us / wall_us if busy_us
            else "not measured",
            "profiled_step_wall_ms": wall_us / 1e3,
            "launches_a_step_by_kernel": dict(
                sorted(by_kernel.items(), key=lambda kv: -kv[1]))}


def _child(root: str, names: list[str]) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import feddrift_torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    package = os.path.dirname(os.path.abspath(feddrift_torch.__file__))
    if os.path.dirname(package) != os.path.abspath(root):
        raise RuntimeError(f"feddrift_torch came from {package}, not {root}")
    for name in names:
        algo, arg = RUNS[name]
        cfg = ExperimentConfig(concept_drift_algo=algo,
                               concept_drift_algo_arg=arg,
                               checkpoint_every_iteration=False)
        Experiment(cfg).run()
        exp = Experiment(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        series = [(r["round"], r["Test/Acc"]) for r in exp.logger.history]
        segments = {}
        for e in exp.events.events("round_breakdown"):
            for k, v in e["segments"].items():
                segments[k] = segments.get(k, 0.0) + v
        pool = hashlib.sha256()
        for k in sorted(exp.pool.params):
            pool.update(k.encode())
            pool.update(exp.pool.params[k].cpu().numpy().tobytes())
        print("ab_run: " + json.dumps({
            "run": name, "algo": algo, "arg": arg, "wall_s": wall,
            "series_sha256": hashlib.sha256(
                json.dumps(series).encode()).hexdigest(),
            "pool_sha256": pool.hexdigest(),
            "segments_s": segments, "test_acc_final": series[-1][1],
            **_profile_step(exp)}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--runs", default="canonical,cfl,aue,kue",
                    help="comma-separated names of " + ", ".join(RUNS))
    ap.add_argument("--repeat", type=int, default=1,
                    help="times to run the four turns")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = args.runs.split(",")
    unknown = set(names) - set(RUNS)
    if unknown:
        ap.error(f"unknown runs {sorted(unknown)}")
    if args.child:
        _child(args.child, names)
        return 0
    if not args.base:
        ap.error("--base is required")
    roots = {"base": os.path.abspath(args.base),
             "this": os.path.dirname(os.path.dirname(
                 os.path.abspath(__file__)))}
    got = {name: {"base": [], "this": []} for name in names}
    for side in ORDER * args.repeat:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             roots[side], "--runs", args.runs],
            capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("ab_run: "):
                rec = json.loads(line[len("ab_run: "):])
                got[rec["run"]][side].append(rec)
                print(f"{side} {line}", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            print(f"torch_ab_runs: the {side} child failed "
                  f"({proc.returncode})", file=sys.stderr)
            return 1
    for name in names:
        base, this = got[name]["base"], got[name]["this"]
        keys = ("launches_per_round", "device_ms_per_round",
                "device_busy_share")
        print("ab: " + json.dumps({
            "run": name, "order": ORDER * args.repeat,
            "wall_s": {"base": [r["wall_s"] for r in base],
                       "this": [r["wall_s"] for r in this]},
            "segments_s": {"base": [r["segments_s"] for r in base],
                           "this": [r["segments_s"] for r in this]},
            **{k: {"base": [r[k] for r in base], "this": [r[k] for r in this]}
               for k in keys},
            "bitwise_equal": len({(r["series_sha256"], r["pool_sha256"])
                                  for r in base + this}) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
