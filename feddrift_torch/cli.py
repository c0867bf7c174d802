"""Command-line entry point of the port: ``python -m feddrift_torch``.

Counterpart of ``feddrift_tpu/cli.py``'s ``run``, ``resume``, ``list``,
``incident``, ``report``, ``lineage`` and ``critical_path`` commands.
``run``'s flags are the
fields of the port's ``ExperimentConfig`` (the reference's flag names), so
a reference launch command runs here unchanged as far as the port goes:

    python -m feddrift_torch run --dataset sea --model fnn \\
        --concept_drift_algo softcluster --concept_drift_algo_arg H_A_C_1_10_0 \\
        --comm_round 200 --train_iterations 10

Metrics and checkpoints go to ``<out_dir>/<dataset>-<model>-<algo>-<arg>-s
<seed>/`` (``--flat_out_dir``: ``<out_dir>`` itself); ``--auto_resume``
continues from a checkpoint found there. It prints one JSON line at the
end, with ``"preempted": true`` when a SIGTERM/SIGINT stopped it at an
iteration boundary after checkpointing. ``resume --out_dir DIR`` continues
the run whose checkpoint is in ``DIR/ckpt`` with the config recorded there;
``list`` prints the port's algorithms, datasets and models; ``incident
TARGET`` renders an incident bundle (or the newest under
``TARGET/incidents/``). ``report RUN_DIR.. [--json] [--trace] [--follow]``
renders a run report (``--trace`` also writes ``trace.json``, the spans,
events and host-profiler slices as one Perfetto timeline; ``--follow``
tails ``events.jsonl`` and evaluates the alert rules offline),
``critical_path RUN_DIR [--json] [--flame]`` splits each iteration's wall
into its segments, and ``lineage RUN_DIR [--dot PATH] [--json]`` replays
the cluster genealogy with oracle ARI; these four are host-only (no
device, no kernel build) and read either package's run directories.
``run`` and ``resume`` run on the card;
``--platform cpu`` runs the plain PyTorch path on the CPU instead. Without
a card and without ``--platform cpu`` they exit non-zero.
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


def _arm_faulthandler(out_dir: str):
    """All-thread stacks of a hard hang, a native crash or ``kill -QUIT``
    to ``<out_dir>/faulthandler.log``; the file stays open for the
    process's life (faulthandler holds its descriptor)."""
    import faulthandler
    os.makedirs(out_dir, exist_ok=True)
    fh = open(os.path.join(out_dir, "faulthandler.log"), "a")
    try:
        faulthandler.enable(file=fh, all_threads=True)
    except (ValueError, OSError, AttributeError):
        pass
    return fh


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="feddrift_torch")
    parser.add_argument("--log_level", type=str, default="info")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_run_args(sub.add_parser("run", help="run a drift-FL experiment"))
    res_p = sub.add_parser("resume", help="resume from a checkpoint")
    res_p.add_argument("--out_dir", type=str, required=True,
                       help="the run directory holding ckpt/")
    res_p.add_argument("--platform", choices=("cuda", "cpu"),
                       default="cuda",
                       help="the device to run on (default: the CUDA card)")
    sub.add_parser("list", help="list algorithms / datasets / models")
    inc_p = sub.add_parser(
        "incident", help="render the triage story of an incident bundle "
                         "(or of the newest under <run_dir>/incidents/)")
    inc_p.add_argument("target", help="incident bundle directory, or a run "
                                      "dir holding <run_dir>/incidents/")
    inc_p.add_argument("--json", action="store_true")

    rep_p = sub.add_parser(
        "report", help="render a run report from events.jsonl + metrics.jsonl")
    rep_p.add_argument("run_dirs", nargs="+")
    rep_p.add_argument("--json", action="store_true")
    rep_p.add_argument("--trace", action="store_true",
                       help="also export <run_dir>/trace.json — a "
                            "Perfetto/chrome://tracing-loadable timeline "
                            "built from spans.jsonl + events.jsonl")
    rep_p.add_argument("--follow", action="store_true",
                       help="bounded tail mode: stream events + health "
                            "alerts (obs/alerts.py, evaluated offline) "
                            "until run_end or --follow-timeout, then "
                            "render the report")
    rep_p.add_argument("--follow-timeout", type=float, default=30.0)
    rep_p.add_argument("--poll", type=float, default=0.5)

    lin_p = sub.add_parser(
        "lineage", help="reconstruct the cluster genealogy DAG from a "
                        "run's events.jsonl, with per-iteration oracle "
                        "ARI/purity for synthetic ground truth "
                        "(obs/lineage.py)")
    lin_p.add_argument("run_dir")
    lin_p.add_argument("--dot", type=str, default=None,
                       help="also write a Graphviz DOT export here")
    lin_p.add_argument("--json", action="store_true")

    cp_p = sub.add_parser(
        "critical_path",
        help="per-round segment breakdown + dominant-segment attribution "
             "from a run dir's spans.jsonl + events.jsonl "
             "(obs/critical_path.py)")
    cp_p.add_argument("run_dir")
    cp_p.add_argument("--json", action="store_true")
    cp_p.add_argument("--flame", action="store_true",
                      help="also print top folded host stacks from the "
                           "run's sampling profiler (hostprof.folded)")
    cp_p.add_argument("--flame-top", type=int, default=10, metavar="N")

    # --log_level is also accepted after the subcommand (SUPPRESS default:
    # an absent post-subcommand flag must not clobber a pre-subcommand one)
    for p in (rep_p, lin_p, cp_p):
        p.add_argument("--log_level", type=str, default=argparse.SUPPRESS,
                       help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(),
                                      logging.INFO),
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")

    # host-side only below until `run` / `resume`: no torch import, no
    # device, no kernel build
    if args.cmd == "report":
        from feddrift_torch.obs.report import main as report_main
        return report_main(args.run_dirs
                           + (["--json"] if args.json else [])
                           + (["--trace"] if args.trace else [])
                           + (["--follow",
                               "--follow-timeout", str(args.follow_timeout),
                               "--poll", str(args.poll)]
                              if args.follow else []))
    if args.cmd == "lineage":
        from feddrift_torch.obs.lineage import main as lineage_main
        return lineage_main([args.run_dir]
                            + (["--dot", args.dot] if args.dot else [])
                            + (["--json"] if args.json else []))
    if args.cmd == "critical_path":
        from feddrift_torch.obs.critical_path import main as cp_main
        return cp_main([args.run_dir]
                       + (["--json"] if args.json else [])
                       + (["--flame", "--flame-top", str(args.flame_top)]
                          if args.flame else []))
    if args.cmd == "incident":
        # host-side only: reading and rendering a bundle needs no device
        from feddrift_torch.obs.incident import incident_main
        return incident_main([args.target]
                             + (["--json"] if args.json else []))
    if args.cmd == "list":
        from feddrift_torch.algorithms import available_algorithms
        from feddrift_torch.data.registry import available_datasets
        from feddrift_torch.models import available_models
        print(json.dumps({"algorithms": available_algorithms(),
                          "datasets": available_datasets(),
                          "models": available_models()}, indent=2))
        return 0

    import torch
    if args.platform == "cuda" and not torch.cuda.is_available():
        print("feddrift_torch: no CUDA device is visible; pass --platform "
              "cpu to run on the CPU", file=sys.stderr)
        return 2
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.obs import incident
    from feddrift_torch.simulation.runner import Experiment
    if args.cmd == "resume":
        out_dir = args.out_dir
        with open(os.path.join(out_dir, "ckpt", "MANIFEST.json")) as f:
            cfg = ExperimentConfig.from_json(json.dumps(json.load(f)["config"]))
        fh = _arm_faulthandler(out_dir)
        exp = Experiment.resume(cfg, out_dir, device=args.platform)
    else:
        cfg = _cfg_from_args(args)
        out_dir = run_dir(cfg, args.flat_out_dir)
        ckpt = os.path.join(out_dir, "ckpt")
        fh = _arm_faulthandler(out_dir)
        if args.auto_resume and (os.path.isdir(ckpt)
                                 or os.path.isdir(ckpt + ".old")):
            exp = Experiment.resume(cfg, out_dir, device=args.platform)
        else:
            exp = Experiment(cfg, out_dir=out_dir, device=args.platform)
    if exp.incidents is not None:
        # kill -QUIT dumps every thread's stack to faulthandler.log and
        # captures a bundle; an uncaught exception in any thread too
        incident.install_process_hooks(exp.incidents, faulthandler_file=fh)
    exp.run()
    print(json.dumps({"Test/Acc": exp.logger.last("Test/Acc"),
                      "Train/Acc": exp.logger.last("Train/Acc"),
                      "rounds": exp.global_round, "out_dir": out_dir,
                      "preempted": exp.preempted}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
