"""The learning rates at which the JAX package's own CPU run of a short
canonical configuration blows up: for each ``lr`` given, whether its
divergence guard fired (``divergence_detected``), with which reason, at
which step and round, and whether the run ended in ``DivergenceError``.
``chip_smoke.py``'s ``train_guard`` phase runs the port on the card at one
of them (``BLOWUP_RUN``: 1e20, a decade past the smallest, 1e19) and holds
its guard to the same verdict.

    JAX_PLATFORMS=cpu python scripts/blowup_lr_search.py [LR ...]

One JSON line an lr. The configuration is ``BLOWUP_RUN``'s without its
``lr`` (SEA, fnn, softcluster H_A_C_1_10_0, 10 clients, a few steps of a
few rounds); a few seconds an lr on one CPU process.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    from chip_smoke import BLOWUP_RUN
    lrs = [float(a) for a in sys.argv[1:]] or [1.0, 1e2, 1e4, 1e8, 1e16,
                                                1e18, 1e19, 1e20]
    from feddrift_tpu.config import ExperimentConfig
    from feddrift_tpu.resilience.divergence import DivergenceError
    from feddrift_tpu.simulation.runner import Experiment
    for lr in lrs:
        t0 = time.time()
        kw = dict(BLOWUP_RUN, lr=lr)
        exp = Experiment(ExperimentConfig(**kw))
        aborted = False
        try:
            exp.run()
        except DivergenceError:
            aborted = True
        evs = exp.events.events("divergence_detected")
        print(json.dumps({
            "lr": lr, "fired": len(evs),
            "reasons": sorted({e["reason"] for e in evs}),
            "first": {k: evs[0].get(k) for k in ("iteration", "round")}
            if evs else None,
            "divergence_error": aborted,
            "test_acc": [a for _, a in exp.logger.series("Test/Acc")][-3:],
            "seconds": round(time.time() - t0, 2)}), flush=True)


if __name__ == "__main__":
    main()
