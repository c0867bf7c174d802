"""Drift-adaptation algorithms of the port (FedDrift's ``softcluster``)."""

from feddrift_torch.algorithms import softcluster  # noqa: F401  (registers)
from feddrift_torch.algorithms.base import (  # noqa: F401
    DriftAlgorithm, algorithm_class, available_algorithms, make_algorithm,
    register_algorithm)
