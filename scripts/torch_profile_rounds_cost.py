"""What the per-round path's device-wait sample costs, on one card.

    python3 scripts/torch_profile_rounds_cost.py [--runs cfl,ada,...]
                                                [--values 10,1000000000]
                                                [--pairs 5]

Runs each named per-round configuration (the canonical SEA setting with
the algorithm named, no checkpoints) at each ``profile_rounds`` value in
turns: one untimed warm-up, then ``--pairs`` rounds of every value, the
order reversed every other round. A run is timed on the host clock around
``Experiment.run`` and a synchronise. Prints one ``profile_rounds_cost``
JSON line per configuration: each value's walls and their median, the
summed ``device_compute`` seconds (the sampled waits themselves) and
``profiled_rounds`` a step of its ``round_breakdown`` events, the mean
``host_overhead_frac``, and whether every value's Test/Acc series is
bitwise the first value's. Then the card's name and power limit. Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run name -> (concept_drift_algo, concept_drift_algo_arg): the per-round
# runs of chip_smoke.py's train_algo phase
RUNS = {"cfl": ("softcluster", "cfl_0.1_win-1"),
        "ada": ("ada", "win-1_iter"),
        "clusterfl": ("clusterfl", "H_A_C_1_10_0"),
        "aue": ("aue", "H_A_C_1_10_0"),
        "auepc": ("auepc", "H_A_C_1_10_0"),
        "kue": ("kue", "H_A_C_1_10_0")}


def _run(algo: str, arg: str, profile_rounds: int) -> dict:
    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(ExperimentConfig(
        concept_drift_algo=algo, concept_drift_algo_arg=arg,
        profile_rounds=profile_rounds, checkpoint_every_iteration=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bds = exp.events.events("round_breakdown")
    return {"wall_s": wall,
            "device_compute_s": sum(b["segments"].get("device_compute", 0.0)
                                    for b in bds),
            "profiled_rounds": [b["profiled_rounds"] for b in bds],
            "host_overhead_frac": statistics.mean(
                b["host_overhead_frac"] for b in bds),
            "series": [(r["round"], r["Test/Acc"])
                       for r in exp.logger.history]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default=",".join(RUNS),
                    help="comma-separated names of " + ", ".join(RUNS))
    ap.add_argument("--values", default="10,1000000000",
                    help="comma-separated profile_rounds values")
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_rounds_cost: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    values = [int(v) for v in args.values.split(",")]
    for name in args.runs.split(","):
        algo, arg = RUNS[name]
        _run(algo, arg, values[0])                   # warm-up
        got = {v: [] for v in values}
        for i in range(args.pairs):
            for v in (values if i % 2 == 0 else values[::-1]):
                got[v].append(_run(algo, arg, v))
        first = got[values[0]][0]["series"]
        print("profile_rounds_cost: " + json.dumps({
            "run": name, "algo": algo, "arg": arg,
            "series_bitwise_equal": all(r["series"] == first
                                        for rs in got.values() for r in rs),
            **{str(v): {"walls_s": [r["wall_s"] for r in rs],
                        "median_wall_s": statistics.median(
                            r["wall_s"] for r in rs),
                        "device_compute_s": [r["device_compute_s"]
                                             for r in rs],
                        "profiled_rounds_a_step": rs[0]["profiled_rounds"],
                        "host_overhead_frac_mean": statistics.mean(
                            r["host_overhead_frac"] for r in rs)}
               for v, rs in got.items()}}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
