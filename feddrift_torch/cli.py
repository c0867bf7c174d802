"""Command-line entry point of the port: ``python -m feddrift_torch run``.

Counterpart of ``feddrift_tpu/cli.py``'s ``run`` command. Its flags are the
fields of the port's ``ExperimentConfig`` (the reference's flag names), so
a reference launch command runs here unchanged as far as the port goes:

    python -m feddrift_torch run --dataset sea --model fnn \\
        --concept_drift_algo softcluster --concept_drift_algo_arg H_A_C_1_10_0 \\
        --comm_round 200 --train_iterations 10

Metrics and checkpoints go to ``<out_dir>/<dataset>-<model>-<algo>-<arg>-s
<seed>/`` (``--flat_out_dir``: ``<out_dir>`` itself); ``--auto_resume``
continues from a checkpoint found there. It runs on the card;
``--platform cpu`` runs the plain PyTorch path on the CPU instead. Without
a card and without ``--platform cpu`` it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys


def _add_run_args(p: argparse.ArgumentParser) -> None:
    from feddrift_torch.config import ExperimentConfig
    for f in dataclasses.fields(ExperimentConfig):
        if f.type in ("int", int):
            p.add_argument(f"--{f.name}", type=int, default=f.default)
        elif f.type in ("float", float):
            p.add_argument(f"--{f.name}", type=float, default=f.default)
        elif f.type in ("bool", bool):
            p.add_argument(f"--{f.name}",
                           type=lambda s: s.lower() in ("1", "true"),
                           default=f.default)
        else:
            p.add_argument(f"--{f.name}", type=str, default=f.default)
    p.add_argument("--flat_out_dir", action="store_true",
                   help="write metrics/ckpt directly under --out_dir instead "
                        "of an auto-named <dataset>-<model>-... subdirectory")
    p.add_argument("--auto_resume", action="store_true",
                   help="if the run dir already holds a checkpoint (ckpt/ or "
                        "ckpt.old/), resume from it instead of starting over")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                   help="the device to run on (default: the CUDA card)")


def _cfg_from_args(args: argparse.Namespace):
    from feddrift_torch.config import ExperimentConfig
    known = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return ExperimentConfig(**{k: v for k, v in vars(args).items()
                               if k in known and v is not None})


def run_dir(cfg, flat: bool = False) -> str:
    """Where a run writes: ``cfg.out_dir``, or its auto-named child."""
    if flat:
        return cfg.out_dir
    return os.path.join(cfg.out_dir,
                        f"{cfg.dataset}-{cfg.model}-{cfg.concept_drift_algo}"
                        f"-{cfg.concept_drift_algo_arg}-s{cfg.seed}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="feddrift_torch")
    parser.add_argument("--log_level", type=str, default="info")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_run_args(sub.add_parser("run", help="run a drift-FL experiment"))
    args = parser.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(),
                                      logging.INFO),
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")

    import torch
    if args.platform == "cuda" and not torch.cuda.is_available():
        print("feddrift_torch: no CUDA device is visible; pass --platform "
              "cpu to run on the CPU", file=sys.stderr)
        return 2
    from feddrift_torch.simulation.runner import Experiment
    cfg = _cfg_from_args(args)
    out_dir = run_dir(cfg, args.flat_out_dir)
    ckpt = os.path.join(out_dir, "ckpt")
    if args.auto_resume and (os.path.isdir(ckpt)
                             or os.path.isdir(ckpt + ".old")):
        exp = Experiment.resume(cfg, out_dir, device=args.platform)
    else:
        exp = Experiment(cfg, out_dir=out_dir, device=args.platform)
    exp.run()
    print(json.dumps({"Test/Acc": exp.logger.last("Test/Acc"),
                      "Train/Acc": exp.logger.last("Train/Acc"),
                      "rounds": exp.global_round, "out_dir": out_dir}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
