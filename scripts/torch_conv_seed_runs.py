#!/usr/bin/env python3
"""The port's card runs of the committed conv configurations at other
seeds: the spread that sets ``chip_smoke.py``'s conv gates.

    python3 scripts/torch_conv_seed_runs.py [--seeds 1,2,3] [--runs NAMES]
        [--checks]

For each run of ``chip_smoke.CONV_RUNS`` (``--runs``: a comma-separated
subset of their committed names) and each seed, one ``conv_seed_run`` line:
the final Test/Acc of every step, their mean and the wall; then one
``conv_seed_spread`` line a run: the largest max - min over the seeds of a
step's final Test/Acc (``step``) and of the runs' means (``mean``), the
pair ``CONV_SEED_SPREAD`` holds. ``--checks`` first runs ``train_conv``'s
model and round checks (``_conv_model_checks``, ``_conv_round_checks``:
float64 comparisons, determinism, the timing case), which read no run's
Test/Acc. Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    import torch

    import chip_smoke
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", default="1,2,3")
    parser.add_argument("--runs", default=None)
    parser.add_argument("--checks", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_conv_seed_runs: needs a CUDA card", file=sys.stderr)
        return 1
    if args.checks:
        chip_smoke._conv_model_checks()
        chip_smoke._conv_round_checks()
    names = None if args.runs is None else args.runs.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    for run, kw, _, _ in chip_smoke.CONV_RUNS:
        if names is not None and run not in names:
            continue
        finals = []
        for seed in seeds:
            t0 = time.perf_counter()
            exp = Experiment(ExperimentConfig(**kw, seed=seed))
            exp.run()
            torch.cuda.synchronize()
            last = {}
            for rec in exp.logger.history:
                last[rec["iteration"]] = rec["Test/Acc"]
            accs = [last[t] for t in sorted(last)]
            finals.append(accs)
            print("conv_seed_run: " + json.dumps(
                {"run": run, "seed": seed, "test_acc": accs,
                 "mean": sum(accs) / len(accs),
                 "wall_s": time.perf_counter() - t0}), flush=True)
            del exp
            torch.cuda.empty_cache()
        step = max(max(col) - min(col) for col in zip(*finals))
        means = [sum(a) / len(a) for a in finals]
        print("conv_seed_spread: " + json.dumps(
            {"run": run, "seeds": seeds, "step": step,
             "mean": max(means) - min(means)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
