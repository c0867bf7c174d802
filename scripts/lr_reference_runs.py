"""Final Test/Acc per time step of the JAX package's own runs of
``chip_smoke.py``'s ``LR_RUNS`` configurations: the series that
``phase_train_lr`` holds the port's runs to. With ``--port`` the port
runs each too, on the CPU from the same initial params.

    JAX_PLATFORMS=cpu python scripts/lr_reference_runs.py sea_lr_sgd \\
        sea_lr_adam --port

One JSON line a run: its label, the reference's Test/Acc at each step's
final eval, whether that equals the series committed in ``LR_RUNS``, and
seconds; with ``--port`` also the port's series, its largest gap at a
step and the gap of the means. The SEA runs take a few seconds each on
one CPU process, the MNIST-4 ones several minutes.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def final_accs(history) -> list[float]:
    final = {}
    for rec in history:
        if "Test/Acc" in rec:
            final[rec["iteration"]] = rec["Test/Acc"]
    return [final[t] for t in sorted(final)]


def port_accs(kw: dict, init) -> list[float]:
    """The port's run of ``kw`` on the CPU, from ``init`` (a flat dict of
    one model's params) when it is given, as ``chip_smoke.py`` starts it."""
    import torch

    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(ExperimentConfig(**kw), device="cpu")
    if init is not None:
        pool = exp.pool
        pool.init_params = {k: torch.as_tensor(init[k], dtype=v.dtype)
                            for k, v in pool.init_params.items()}
        pool.params = {k: v[None].expand(pool.num_models, *v.shape).clone()
                       for k, v in pool.init_params.items()}
    exp.run()
    return final_accs(exp.logger.history)


def main() -> None:
    from chip_smoke import LR_RUNS
    runs = {run[0]: run[1:] for run in LR_RUNS}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("labels", nargs="+", choices=sorted(runs))
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU")
    args = ap.parse_args()
    from feddrift_tpu.config import ExperimentConfig
    from feddrift_tpu.simulation.runner import Experiment
    for label in args.labels:
        kw, ref, init = runs[label][:3]
        t0 = time.time()
        exp = Experiment(ExperimentConfig(**kw))
        exp.run()
        accs = final_accs(exp.logger.history)
        out = {"run": label, "test_acc": accs,
               "equals_committed": tuple(accs) == tuple(ref)}
        if args.port:
            ours = port_accs(kw, init)
            out.update(port_test_acc=ours, largest_step_gap=max(
                abs(a - b) for a, b in zip(ours, accs)),
                mean_gap=abs(sum(ours) - sum(accs)) / len(accs))
        print(json.dumps(dict(out, seconds=time.time() - t0)), flush=True)


if __name__ == "__main__":
    main()
