"""Drift-adaptation algorithms of the port: the ``softcluster`` family, the
single-model baselines, the state-machine algorithms (DriftSurf,
MultiModel, Adaptive-FedAvg, the legacy ClusterFL) and the streaming
ensembles (AUE, AUE-PC, KUE)."""

from feddrift_torch.algorithms import (  # noqa: F401
    ensembles, singlemodel, softcluster, statebased)
from feddrift_torch.algorithms.base import (  # noqa: F401
    DriftAlgorithm, EnsembleSpec, algorithm_class, available_algorithms,
    make_algorithm, register_algorithm)
