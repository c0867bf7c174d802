"""Final Test/Acc per time step of MNIST-4 (or, with ``--dataset fmow``,
FMoW) runs of the JAX package at other seeds, and their means against a
committed run's: the spread by which ``chip_smoke.py``'s ``MNIST_RUNS`` and
``FMOW_RUNS`` gate the port's clustering runs.

    JAX_PLATFORMS=cpu python scripts/mnist_seed_runs.py softcluster \\
        H_A_F_1_3_0 --pool 10 --seeds 1 2 --steps 10 \\
        --committed runs/MNIST-fnn-softcluster-H_A_F_1_3_0-s0/metrics.jsonl

One JSON line a seed (its Test/Acc at each step's final eval, its mean,
seconds), then one line with the committed run's mean over the same steps
and the largest |mean(seed) - mean(committed)|. ``--port`` runs the
port's ``Experiment`` on the CPU instead (its plain kernels), from the JAX
package's initial pool for that seed: a rounding-only sample beside the
reference's own. A 10-step run of the fnn at
MNIST-4's width takes ~9 minutes at a pool of 4 and ~15 at 10 on one CPU
process. ``--steps`` cuts a run short (FMoW's F = 3072 makes a step several
times dearer); the committed run's mean is then taken over the same steps.

    JAX_PLATFORMS=cpu python scripts/mnist_seed_runs.py softcluster \\
        H_A_C_1_10_0 --dataset fmow --seeds 0 1 2 --steps 10 \\
        --committed runs/fmow-fnn-softcluster-H_A_C_1_10_0-s0/metrics.jsonl
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


def port_experiment(kw: dict, ref):
    """The port's CPU ``Experiment`` of the same configuration, its pool
    (every slot and the reinit target) the reference's initial one."""
    import jax
    import numpy as np

    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.convert import params_from_jax
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(ExperimentConfig(**kw), device="cpu")
    tree = lambda t: params_from_jax(jax.tree_util.tree_map(np.asarray, t),
                                     "cpu")
    exp.pool.init_params = tree(ref.pool.init_params)
    exp.pool.params = tree(ref.pool.params)
    return exp


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("algo")
    ap.add_argument("arg")
    ap.add_argument("--dataset", default="MNIST",
                    choices=("MNIST", "fmow", "susy", "ro",
                             "stackoverflow_lr", "femnist", "cifar10"),
                    help="the dataset, at its registry defaults (fmow at "
                         "32x32x3)")
    ap.add_argument("--pool", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--committed",
                    help="metrics.jsonl of the committed seed-0 run, where "
                         "there is one")
    ap.add_argument("--port", action="store_true",
                    help="run the port on the CPU from the reference's init")
    args = ap.parse_args()
    from feddrift_tpu.config import ExperimentConfig
    from feddrift_tpu.simulation.runner import Experiment
    means = []
    for seed in args.seeds:
        kw = dict(dataset=args.dataset, concept_drift_algo=args.algo,
                  concept_drift_algo_arg=args.arg, concept_num=args.pool,
                  train_iterations=args.steps, seed=seed)
        t0 = time.time()
        exp = Experiment(ExperimentConfig(**kw))
        if args.port:
            exp = port_experiment(kw, exp)
        exp.run()
        accs = final_accs(exp.logger.history)
        means.append(sum(accs) / len(accs))
        print(json.dumps({"seed": seed, "test_acc": accs, "mean": means[-1],
                          "seconds": time.time() - t0}), flush=True)
    if not args.committed:
        return
    with open(args.committed) as f:
        ref = final_accs(json.loads(line) for line in f)[:args.steps]
    ref_mean = sum(ref) / len(ref)
    print(json.dumps({"committed_mean": ref_mean,
                      "largest_mean_gap": max(abs(m - ref_mean)
                                              for m in means)}))


if __name__ == "__main__":
    main()
