"""DriftDataset: the dense representation of drifting federated data.

The reference materialises one CSV per (client, time step)
(``client_{c}_iter_{t}.csv``, sea/data_loader.py:69-82) and re-reads them from
disk in every MPI process. Here the whole simulation's data is a pair of dense
arrays with static shapes:

    x: [C, T+1, N, ...]   features  (T+1: step T is the final held-out test step)
    y: [C, T+1, N]        int32 labels

Per-(t, c) sample counts are constant (``sample_num``, reference default 500,
run_fedavg_distributed_pytorch.sh:15), so no padding/ragged handling is needed.
Test data for training step t is step t+1 (temporal holdout, retrain.py:78-83).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class DriftDataset:
    x: np.ndarray                # [C, T+1, N, *feature_shape] float32
    y: np.ndarray                # [C, T+1, N] int32
    num_classes: int
    concepts: np.ndarray         # [T+1, C] concept id per (step, client)
    name: str = "synthetic"
    # Optional sequence data flag (inputs are int token ids rather than floats)
    is_sequence: bool = False
    meta: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        assert self.x.shape[:3] == self.y.shape, (self.x.shape, self.y.shape)
        assert self.concepts.shape[0] == self.x.shape[1]

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def num_steps(self) -> int:
        """Number of *training* time steps T (last array slot is test-only)."""
        return self.x.shape[1] - 1

    @property
    def samples_per_step(self) -> int:
        return self.x.shape[2]

    @property
    def feature_shape(self) -> tuple[int, ...]:
        return self.x.shape[3:]
