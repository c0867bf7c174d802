#!/usr/bin/env python3
"""The port's card runs of the committed conv or LSTM configurations at
other seeds: the spread that sets ``chip_smoke.py``'s conv and LSTM gates.

    python3 scripts/torch_conv_seed_runs.py [--family conv|rnn|readers]
        [--seeds 1,2,3] [--runs NAMES] [--checks] [--draws card|cpu]
        [--platform cuda|cpu]

For each run of ``chip_smoke.CONV_RUNS`` (``--family rnn``:
``chip_smoke.RNN_RUNS``; ``--family readers``:
``chip_smoke.READER_CONV_RUNS``, on the digits that
``chip_smoke.write_digits`` lays out in a temporary directory;
``--runs``: a comma-separated subset of their committed names) and each
seed, one ``conv_seed_run`` line: the final Test/Acc of every step,
their mean and the wall; then one ``conv_seed_spread`` line a run: the
largest max - min over the seeds of a step's final Test/Acc (``step``)
and of the runs' means (``mean``), the pair ``CONV_SEED_SPREAD``
(``RNN_SEED_SPREAD``) holds. ``--checks`` first runs ``train_conv``'s
model and round checks (``_conv_model_checks``, ``_conv_round_checks``:
float64 comparisons, determinism, the timing case; for ``rnn``
``train_rnn``'s ``_lstm_cell_checks``, ``_rnn_model_checks`` and
``_rnn_round_checks``), which read no run's Test/Acc. It first prints
``chip_smoke``'s ``device`` line (the card's name and power limit).
Needs the card; imports nothing of JAX.

``--draws cpu`` draws the batches from a CPU generator (seeded as the
card's), so a card run takes the draws of the port's CPU run of the same
seed; ``--platform cpu`` runs that CPU run (no card needed, no checks,
no device line). The two side by side differ in the device alone: the
same init, data and draws.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    import torch

    import chip_smoke
    parser = argparse.ArgumentParser()
    parser.add_argument("--family", choices=("conv", "rnn", "readers"),
                        default="conv")
    parser.add_argument("--seeds", default="1,2,3")
    parser.add_argument("--runs", default=None)
    parser.add_argument("--checks", action="store_true")
    parser.add_argument("--draws", choices=("card", "cpu"), default="card")
    parser.add_argument("--platform", choices=("cuda", "cpu"),
                        default="cuda")
    args = parser.parse_args()
    if args.platform == "cpu":
        args.checks, args.draws = False, "cpu"
    elif not torch.cuda.is_available():
        print("torch_conv_seed_runs: needs a CUDA card", file=sys.stderr)
        return 1
    else:
        chip_smoke.phase_device()
    rnn = args.family == "rnn"
    if args.checks and rnn:
        chip_smoke.phase_build()
        chip_smoke._lstm_cell_checks()
        chip_smoke._rnn_model_checks()
        chip_smoke._rnn_round_checks()
    elif args.checks:
        chip_smoke._conv_model_checks()
        chip_smoke._conv_round_checks()
    names = None if args.runs is None else args.runs.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    with tempfile.TemporaryDirectory() as data_dir:
        extra = {}
        if args.family == "readers":
            chip_smoke.write_digits(data_dir)
            extra = {"data_dir": data_dir}
        runs = {"rnn": chip_smoke.RNN_RUNS,
                "readers": chip_smoke.READER_CONV_RUNS}.get(
            args.family, chip_smoke.CONV_RUNS)
        for run, kw, _, _ in runs:
            if names is None or run in names:
                _seed_runs(run, dict(kw, **extra), seeds, args.platform,
                           args.draws)
    return 0


def _seed_runs(run: str, kw: dict, seeds: list[int], platform: str = "cuda",
               draws: str = "card") -> None:
    """``run``'s configuration ``kw`` at each seed on ``platform``, the
    batches drawn on ``draws``' generator: a ``conv_seed_run`` line each,
    then the ``conv_seed_spread`` line."""
    import torch

    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    finals = []
    for seed in seeds:
        t0 = time.perf_counter()
        exp = Experiment(ExperimentConfig(**kw, seed=seed), device=platform)
        if draws == "cpu":
            exp.step.generator = torch.Generator()
        if "data_dir" in kw and exp.ds.meta.get("real_data") is not True:
            raise RuntimeError(f"{run}: the real files under "
                               f"{kw['data_dir']} were not read")
        exp.run()
        if platform == "cuda":
            torch.cuda.synchronize()
        last = {}
        for rec in exp.logger.history:
            last[rec["iteration"]] = rec["Test/Acc"]
        accs = [last[t] for t in sorted(last)]
        finals.append(accs)
        print("conv_seed_run: " + json.dumps(
            {"run": run, "seed": seed, "platform": platform,
             "draws": draws, "test_acc": accs,
             "mean": sum(accs) / len(accs),
             "wall_s": time.perf_counter() - t0}), flush=True)
        del exp
        if platform == "cuda":
            torch.cuda.empty_cache()
    step = max(max(col) - min(col) for col in zip(*finals))
    means = [sum(a) / len(a) for a in finals]
    print("conv_seed_spread: " + json.dumps(
        {"run": run, "seeds": seeds, "step": step,
         "mean": max(means) - min(means)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
