"""Drift-adaptation algorithms of the port: the ``softcluster`` family and
the single-model baselines."""

from feddrift_torch.algorithms import singlemodel, softcluster  # noqa: F401
from feddrift_torch.algorithms.base import (  # noqa: F401
    DriftAlgorithm, algorithm_class, available_algorithms, make_algorithm,
    register_algorithm)
