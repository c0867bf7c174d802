"""Deterministic generator seeds per (experiment seed, time step).

Counterpart of ``feddrift_tpu/utils/prng.py::iteration_key``: there every
consumer folds structured coordinates into a JAX key; here the train step
seeds its ``torch.Generator`` at each time step with a number derived from
``(seed, t)``, so a run resumed at step t draws exactly what a continuous
run draws there. torch's generators are not JAX's, so the draws themselves
differ from the reference's.
"""

from __future__ import annotations

import numpy as np

TRAIN_STREAM = 0      # the batch draws' stream id in the seed's entropy


def iteration_seed(seed: int, t: int) -> int:
    """A 63-bit generator seed for time step ``t``'s batch draws."""
    words = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, TRAIN_STREAM, int(t)]
    ).generate_state(2, np.uint32)
    return (int(words[0]) << 31 ^ int(words[1])) & (2 ** 63 - 1)

