"""Final Test/Acc per time step, and the mean softcluster ``gmm`` weight on
model 0 per step, of the JAX package's own run of ``chip_smoke.py``'s
``GMM_RUN`` configuration (SEA, fnn, ``softcluster gmm``, 10 steps of 200
rounds): the series that ``phase_train_gmm`` holds the port's run to. With
``--port`` the port runs it too, on the CPU, from the reference's initial
params (``CFL_REFERENCE_INIT``: the same SEA fnn pool), as the phase starts
it on the card.

    JAX_PLATFORMS=cpu python scripts/gmm_reference_runs.py [--port]
        [--algo softcluster|softclusterreset]

One JSON line: the reference's Test/Acc at each step's final eval, its
mean weight on model 0 at each step, whether both equal the series pinned
in ``chip_smoke.py`` (``GMM_RUN``), and seconds; with ``--port`` also the
port's series, its largest gap at a step and the gap of the means. The
reference's ``gmm`` fits scikit-learn's ``GaussianMixture``, so this
script needs scikit-learn beside the JAX package; the port does not.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def final_accs(history) -> list[float]:
    final = {}
    for rec in history:
        if "Test/Acc" in rec:
            final[rec["iteration"]] = rec["Test/Acc"]
    return [final[t] for t in sorted(final)]


def model0_weight(weights, T: int) -> list[float]:
    """The mean over clients of each step's weight on model 0."""
    return [float(np.mean(np.asarray(weights[t])[0])) for t in range(T)]


def main() -> None:
    from chip_smoke import CFL_REFERENCE_INIT, GMM_RUN
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU")
    ap.add_argument("--algo", default=GMM_RUN["kw"]["concept_drift_algo"],
                    choices=("softcluster", "softclusterreset"))
    args = ap.parse_args()
    kw = dict(GMM_RUN["kw"], concept_drift_algo=args.algo)
    from feddrift_tpu.config import ExperimentConfig
    from feddrift_tpu.simulation.runner import Experiment
    t0 = time.time()
    exp = Experiment(ExperimentConfig(**kw))
    exp.run()
    T = exp.cfg.train_iterations
    accs = final_accs(exp.logger.history)
    w0 = model0_weight(exp.algo.weights, T)
    pinned = args.algo == GMM_RUN["kw"]["concept_drift_algo"]
    out = {"kw": kw, "test_acc": accs, "model0_weight": w0,
           "equals_committed": pinned
           and tuple(accs) == tuple(GMM_RUN["test_acc"])
           and np.allclose(w0, GMM_RUN["model0_weight"], rtol=0,
                           atol=1e-6)}
    if args.port:
        import torch

        from feddrift_torch.config import ExperimentConfig as PortConfig
        from feddrift_torch.simulation.runner import Experiment as PortExp
        port = PortExp(PortConfig(**kw), device="cpu")
        pool = port.pool
        pool.init_params = {
            k: torch.as_tensor(CFL_REFERENCE_INIT[k], dtype=v.dtype)
            for k, v in pool.init_params.items()}
        pool.params = {k: v[None].expand(pool.num_models, *v.shape).clone()
                       for k, v in pool.init_params.items()}
        port.run()
        ours = final_accs(port.logger.history)
        out.update(port_test_acc=ours,
                   port_model0_weight=model0_weight(port.algo.weights, T),
                   largest_step_gap=max(abs(a - b)
                                        for a, b in zip(ours, accs)),
                   mean_gap=abs(sum(ours) - sum(accs)) / len(accs))
    print(json.dumps(dict(out, seconds=time.time() - t0)), flush=True)


if __name__ == "__main__":
    main()
