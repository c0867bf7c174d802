"""FedDrift's clustering (``softcluster`` with ``H_*`` arguments) in the port
against the JAX package, from identical accuracy inputs.

Both algorithms get the same dataset, the same pool (the JAX pool carried
across with ``pool_from_jax``) and the same scripted accuracy matrices and
cells: ``acc_matrix_at`` and ``acc_cells_upto`` are overridden on the two
instances, so the device plays no part. Each time step must then give the
same weights tensor, isolation marks, detector arms, spawns, merges, LRU
picks (both draw from ``default_rng(seed + 1009)``), pool contents (atol
1e-7: merges are float32 lerps) and emitted events (``drift_detected``,
``cluster_create``, ``cluster_merge``, ``cluster_delete``,
``cluster_state``, ``cluster_assign``; ``_ts`` aside).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from feddrift_torch import obs as tobs
from feddrift_torch.algorithms import make_algorithm
from feddrift_torch.config import ExperimentConfig
from feddrift_torch.convert import params_from_jax, pool_from_jax
from feddrift_torch.data.registry import make_dataset
from feddrift_torch.models.mlp import FeedForwardNN
from feddrift_torch.utils.metrics import MetricsLogger

M, C, T, N = 4, 6, 7, 50
KINDS = ("drift_detected", "cluster_create", "cluster_merge",
         "cluster_delete", "cluster_state", "cluster_assign")


def _scripted(seed):
    """[T1] accuracy matrices [M, C] and correct-count cells [M, C, T1]:
    per-(client, step) bases, small per-model offsets (so some clusters
    merge), and accuracy drops for a few (client, step) pairs (so drift
    fires and slots are spawned and reused)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.6, 0.9, (C, T + 1))
    bias = rng.normal(0.0, 0.05, (M, C, T + 1))
    drop = np.zeros((C, T + 1))
    for c, t in zip(rng.integers(0, C, 8), rng.integers(1, T, 8)):
        drop[c, t] = 0.25
    acc = np.clip(base[None] + bias - drop[None], 0.0, 1.0)
    cells = np.round(acc * N).astype(np.int32)
    return cells / N, cells


def _pair(arg, seed):
    from feddrift_tpu.algorithms import make_algorithm as jmake
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.core.pool import ModelPool as JPool
    from feddrift_tpu.data.registry import make_dataset as jdata
    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    from feddrift_tpu.utils.metrics import MetricsLogger as JLogger
    kw = dict(client_num_in_total=C, client_num_per_round=C,
              train_iterations=T, sample_num=N, concept_num=M,
              concept_drift_algo_arg=arg, seed=seed)
    jcfg, cfg = JCfg(**kw), ExperimentConfig(**kw)
    jpool = JPool.create(JFnn(num_classes=2, hidden_dim=4),
                         jnp.zeros((2, 3)), M, seed=seed, identical=False)
    pool = pool_from_jax(jpool, FeedForwardNN((3,), 2, 4), "cpu")
    jalgo = jmake(jcfg, jdata(jcfg), jpool, None)
    algo = make_algorithm(cfg, make_dataset(cfg), pool,
                          types.SimpleNamespace(device="cpu"))
    jalgo.bind(None, None, JLogger(None), C)
    algo.bind(None, None, MetricsLogger(None))
    acc, cells = _scripted(seed)
    for a in (jalgo, algo):
        a.acc_matrix_at = lambda t, feat_mask=None: acc[:, :, t]
        a.acc_cells_upto = lambda t, feat_mask=None: cells[:, :, : t + 1]
    return jalgo, algo


def _events(bus):
    return [{k: v for k, v in e.items() if k != "_ts"}
            for e in bus.events() if e["kind"] in KINDS]


@pytest.mark.parametrize("arg,seed", [
    ("H_A_C_1_10_0", 0), ("H_A_C_1_10_0", 1), ("H_A_E_1_10_0", 2),
    ("H_B_C_2_10_5", 3), ("H_A_D_1_8_12", 4)])
def test_same_decisions_from_same_accuracies(arg, seed):
    from feddrift_tpu import obs as jobs
    jbus, bus = jobs.configure(None), tobs.configure(None)
    jalgo, algo = _pair(arg, seed)
    for t in range(T):
        jbus.set_context(iteration=t)
        bus.set_context(iteration=t)
        jalgo.begin_iteration(t)
        algo.begin_iteration(t)
        assert np.array_equal(algo.weights, jalgo.weights), t
        assert algo.h_marked == jalgo.h_marked, t
        np.testing.assert_array_equal(algo.mmacc_acc, jalgo.mmacc_acc)
        assert algo.h_next_free == jalgo.h_next_free
        assert algo.event_counts == jalgo.event_counts
        want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jalgo.pool.params), "cpu")
        for k, v in algo.pool.params.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-7)
        assert algo.logger.summary == jalgo.logger.summary
        assert algo._tw.shape == (M, C, T + 1)
        assert np.array_equal(algo._tw.numpy(), np.asarray(jalgo._tw))
        assert np.array_equal(algo.test_model_idx(t), jalgo.test_model_idx(t))
    got, want = _events(bus), _events(jbus)
    assert got == want
    kinds = {e["kind"] for e in got}
    assert {"drift_detected", "cluster_create", "cluster_state",
            "cluster_assign"} <= kinds
    if arg == "H_A_C_1_10_0" and seed == 0:
        assert "cluster_merge" in kinds


def test_state_round_trip_continues_identically():
    _, a = _pair("H_A_C_1_10_0", 5)
    _, b = _pair("H_A_C_1_10_0", 5)
    for t in range(3):
        a.begin_iteration(t)
        b.begin_iteration(t)
    import pickle
    b.load_state_dict(pickle.loads(pickle.dumps(a.state_dict())))
    b.pool.params = a.pool.params
    for t in range(3, T):
        a.begin_iteration(t)
        b.begin_iteration(t)
        assert np.array_equal(a.weights, b.weights)
        assert a.h_marked == b.h_marked


@pytest.mark.parametrize("algo,arg", [("softcluster", "mmacc_06"),
                                      ("softcluster", "hard"),
                                      ("softclusterwin-1", "H_A_C_1_10_0")])
def test_other_kinds_not_ported(algo, arg):
    cfg = ExperimentConfig(concept_drift_algo=algo, concept_drift_algo_arg=arg,
                           sample_num=10, train_iterations=2)
    from feddrift_torch.core.pool import ModelPool
    pool = ModelPool.create(FeedForwardNN((3,), 2, 4), None, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        make_algorithm(cfg, make_dataset(cfg), pool, None)
    with pytest.raises(KeyError):
        make_algorithm(ExperimentConfig(concept_drift_algo="kue"), None,
                       pool, None)
