"""softcluster ``gmm`` in the port against scikit-learn and the JAX package.

``feddrift_torch/algorithms/gmm.py`` computes, without scikit-learn,
``GaussianMixture(n_components=2, random_state=0).fit(X).predict_proba(X)``
of the reference's ``_cluster_gmm`` on ``X = acc.T`` (clients x models).
It is held to scikit-learn itself on ``[C, M]`` accuracy matrices (each
model an accuracy column): the first clustered step of the canonical run,
where every model but 0 is still its identical initial draw (identical
columns); two separated groups of clients; uniform noise in [0.4, 1];
quantised accuracies with repeated rows; at M = 2 and M = 4.
``predict_proba`` and the means within 1e-6, and the reference's 0/1 swap
(``means_[0][0] > means_[0][1]``) the same. Then both packages'
``softcluster``, ``softclusterreset`` and ``softclusterwin-1`` with
``gmm`` decide from the same scripted accuracy matrices (the harness of
``test_torch_softcluster.py``) and must give equal weights and events, and
a small CPU run of the port trains through it on the fused path. Only the
comparisons with scikit-learn itself skip where it is absent.
"""

import numpy as np
import pytest
import torch

from feddrift_torch import obs as tobs
from feddrift_torch.algorithms.gmm import GaussianMixture
from feddrift_torch.config import ExperimentConfig
from test_torch_softcluster import _assert_same_state, _events, _pair
from torch_threads import one_intra_op_thread  # noqa: F401

ATOL = 1e-6


def _canonical_step1() -> np.ndarray:
    """acc.T [C, M] at the canonical run's first clustering: step 0 trains
    model 0 alone, so models 1..3 are the pool's initial draws."""
    from feddrift_torch.simulation.runner import Experiment
    cfg = ExperimentConfig(concept_drift_algo_arg="gmm", train_iterations=2,
                           comm_round=20)
    exp = Experiment(cfg, device="cpu")
    exp.run_iteration(0)
    return exp.algo.acc_matrix_at(1).T


def _matrix(kind: str, M: int, seed: int, C: int = 10) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "separated":
        a = rng.normal(0.6, 0.02, (C // 2, M))
        b = rng.normal(0.9, 0.02, (C - C // 2, M))
        return np.concatenate([a, b])
    if kind == "uniform":
        return rng.uniform(0.4, 1.0, (C, M))
    if kind == "identical_columns":
        x = np.repeat(rng.uniform(0.4, 1.0, (C, 1)), M, 1)
        x[:, 0] = rng.uniform(0.4, 1.0, C)
        return x
    # quantised accuracies of 500 rows, repeated client rows
    x = rng.integers(240, 260, (C, M)) / 500.0
    x[C // 2:] = x[0]
    return x


CASES = [(k, M, s) for k in ("separated", "uniform", "identical_columns",
                             "quantised") for M in (2, 4) for s in (0, 1)]


@pytest.fixture(scope="module")
def canonical_step1():
    return _canonical_step1()


def _against_sklearn(x: np.ndarray) -> None:
    sk = pytest.importorskip("sklearn.mixture")
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # KMeans' duplicate-point note
        gm = sk.GaussianMixture(n_components=2, random_state=0).fit(x)
        want = gm.predict_proba(x)
    mine = GaussianMixture().fit(x)
    got = mine.predict_proba(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(mine.means_, gm.means_, rtol=0, atol=ATOL)
    assert (mine.means_[0][0] > mine.means_[0][1]) \
        == (gm.means_[0][0] > gm.means_[0][1])


@pytest.mark.parametrize("kind,M,seed", CASES,
                         ids=[f"{k}-M{M}-s{s}" for k, M, s in CASES])
def test_predict_proba_matches_sklearn(kind, M, seed):
    _against_sklearn(_matrix(kind, M, seed))


def test_canonical_first_step_matches_sklearn(canonical_step1):
    x = canonical_step1
    assert x.shape == (10, 4)
    # models 1..3 were never trained: their accuracy columns are equal
    assert (x[:, 1:] == x[:, 1:2]).all()
    _against_sklearn(x)


def test_gmm_takes_no_sklearn():
    import subprocess
    import sys
    code = ("import sys; import feddrift_torch.algorithms.softcluster; "
            "import feddrift_torch.algorithms.gmm; "
            "sys.exit(int('sklearn' in sys.modules))")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


@pytest.mark.parametrize("algo_name,seed", [
    ("softcluster", 0), ("softcluster", 1), ("softcluster", 2),
    ("softclusterreset", 3), ("softclusterwin-1", 4)])
def test_same_decisions_from_same_accuracies(algo_name, seed):
    """Both packages' gmm kinds from the same scripted accuracy matrices:
    equal [T1, M, C] weights (fractional, on models 0 and 1 only), pool
    and events at every step."""
    pytest.importorskip("sklearn.mixture")     # the reference's gmm fits it
    from feddrift_tpu import obs as jobs
    jbus, bus = jobs.configure(None), tobs.configure(None)
    jalgo, algo = _pair("gmm", seed, algo_name)
    T = algo.weights.shape[0] - 1
    for t in range(T):
        jbus.set_context(iteration=t)
        bus.set_context(iteration=t)
        jalgo.begin_iteration(t)
        algo.begin_iteration(t)
        _assert_same_state(jalgo, algo, t)
        assert algo.chunkable(t) and jalgo.chunkable(t)
        if t > 0:
            w = algo.weights[t]
            assert not w[2:].any()
            np.testing.assert_allclose(w[0] + w[1], 1.0, atol=1e-6)
    assert _events(bus) == _events(jbus)


def test_port_run_trains_fused_with_fractional_weights():
    """A small CPU run of the port: every step on the fused path, gmm's
    weights fractional on models 0 and 1, finite metrics."""
    from feddrift_torch.simulation.runner import Experiment
    cfg = ExperimentConfig(concept_drift_algo_arg="gmm", train_iterations=3,
                           comm_round=10, sample_num=100, batch_size=50)
    exp = Experiment(cfg, device="cpu")
    paths = []
    fused = exp._run_iteration_fused
    exp._run_iteration_fused = lambda t, o: (paths.append(t), fused(t, o))
    exp.run()
    assert paths == [0, 1, 2]
    w = exp.algo.weights
    assert not w[1:3, 2:].any() and (w[1:3, :2] > 0).any()
    assert all(np.isfinite(v) for rec in exp.logger.history
               for k, v in rec.items() if "/" in k)
    assert torch.isfinite(exp.pool.params["Dense_0/kernel"]).all()
