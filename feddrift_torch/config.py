"""Experiment configuration: the fields the ported slices read.

A copy of the subset of ``feddrift_tpu/config.py::ExperimentConfig`` that
the port uses so far, with the same names and defaults, so one set of
keyword arguments builds the same experiment in both packages. Fields are
added here as later slices need them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ExperimentConfig:
    model: str = "fnn"
    dataset: str = "sea"
    data_dir: str = "./data"
    client_num_in_total: int = 10
    train_iterations: int = 10         # number of simulated time steps T
    sample_num: int = 500              # samples per client per time step
    concept_drift_algo: str = "softcluster"
    concept_num: int = 4               # model-pool size M (and #concepts)
    drift_together: int = 0
    change_points: str = "A"           # preset name, 'rand', or matrix literal
    time_stretch: int = 1
    noise_prob: float = 0.0
    ensemble_window: int = 3           # AUE window (sets num_models for aue)
    text_seq_len: int = 80             # char-dataset sequence length
    seed: int = 0

    def __post_init__(self) -> None:
        if self.time_stretch < 1:
            raise ValueError("time_stretch must be >= 1")

    @property
    def num_models(self) -> int:
        """Size M of the static model pool (reference caps at concept_num)."""
        if self.concept_drift_algo in ("aue", "auepc"):
            return self.ensemble_window
        if self.concept_drift_algo == "driftsurf":
            return 2
        if self.concept_drift_algo in ("ada", "win-1", "all", "exp", "lin",
                                       "oblivious", "window"):
            return 1
        return self.concept_num
