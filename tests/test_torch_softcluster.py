"""The ``softcluster`` family in the port against the JAX package, from
identical accuracy inputs.

Both algorithms get the same dataset, the same pool (the JAX pool carried
across with ``pool_from_jax``) and the same scripted accuracy matrices and
cells: ``acc_matrix_at`` and ``acc_cells_upto`` are overridden on the two
instances, so the device plays no part. Each time step must then give the
same weights tensor, isolation marks, detector arms, spawns, merges, LRU
picks (both draw from ``default_rng(seed + 1009)``), pool contents (atol
1e-7: merges are float32 lerps) and emitted events (``drift_detected``,
``cluster_create``, ``cluster_merge``, ``cluster_delete``,
``cluster_split``, ``cluster_state``, ``cluster_assign``; ``_ts`` aside).
Covered: FedDrift (``H_*``), FedDrift-Eager (``mmacc``), IFCA (``hard``,
and ``hard-r`` round by round), ``softmax``, the ``geni`` oracle and the
``softclusterwin-1`` / ``softclusterreset`` variants. IFCA's distinct
initial models come from each package's own generator, so the tests check
that both drew them with the same seeds and then carry the reference's
across. CFL gets the same scripted client updates in both packages; its
norms and cosines sum the coordinates in another order (flax's leaf order
against the port's packing), so ``cfl_norm``, the eps values and the
split events' norms match within 1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddrift_torch import obs as tobs
from feddrift_torch.algorithms import make_algorithm
from feddrift_torch.config import ExperimentConfig
from feddrift_torch.convert import params_from_jax, pool_from_jax
from feddrift_torch.data.registry import make_dataset
from feddrift_torch.models.mlp import FeedForwardNN
from feddrift_torch.utils.metrics import MetricsLogger
from torch_threads import one_intra_op_thread  # noqa: F401

M, C, T, N = 4, 6, 7, 50
KINDS = ("drift_detected", "cluster_create", "cluster_merge",
         "cluster_delete", "cluster_split", "cluster_state", "cluster_assign")
IFCA = ("hard", "hard-r")


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


def _pair(arg, seed, algo_name="softcluster"):
    from feddrift_tpu.algorithms import make_algorithm as jmake
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.core.pool import ModelPool as JPool
    from feddrift_tpu.data.registry import make_dataset as jdata
    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    from feddrift_tpu.utils.metrics import MetricsLogger as JLogger
    kw = dict(client_num_in_total=C, client_num_per_round=C,
              train_iterations=T, sample_num=N, concept_num=M,
              concept_drift_algo=algo_name, concept_drift_algo_arg=arg,
              seed=seed)
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


def _record_distinct_inits(pool):
    """Record the (slot, seed) of every IFCA distinct reinit of ``pool``."""
    calls, orig = [], pool.distinct_reinit_slot

    def record(m, seed):
        calls.append((m, seed))
        orig(m, seed=seed)
    pool.distinct_reinit_slot = record
    return calls


def _jax_params(jalgo):
    return params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  jalgo.pool.params), "cpu")


def _assert_same_state(jalgo, algo, t):
    assert np.array_equal(algo.weights, jalgo.weights), t
    assert algo.h_marked == jalgo.h_marked, t
    np.testing.assert_array_equal(algo.mmacc_acc, jalgo.mmacc_acc)
    assert algo.h_next_free == jalgo.h_next_free
    assert algo.event_counts == jalgo.event_counts
    want = _jax_params(jalgo)
    for k, v in algo.pool.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-7)
    assert algo.logger.summary == jalgo.logger.summary
    assert algo._tw.shape == (M, C, T + 1)
    assert np.array_equal(algo._tw.numpy(), np.asarray(jalgo._tw))
    assert np.array_equal(algo.test_model_idx(t), jalgo.test_model_idx(t))


def _begin(jalgo, algo, t):
    """begin_iteration(t) in both; at t = 0 an IFCA kind draws its distinct
    models, each package from its own generator: check the seeds agree and
    carry the reference's models across."""
    calls = [_record_distinct_inits(a.pool) for a in (jalgo, algo)] \
        if t == 0 and algo.kind in IFCA else None
    jalgo.begin_iteration(t)
    algo.begin_iteration(t)
    if calls is not None:
        assert calls[0] == calls[1] == [
            (m, algo.cfg.seed + 7700 + m) for m in range(M)]
        algo.pool.params = _jax_params(jalgo)


def _events(bus):
    return [{k: v for k, v in e.items() if k != "_ts"}
            for e in bus.events() if e["kind"] in KINDS]


@pytest.mark.parametrize("algo_name,arg,seed", [
    ("softcluster", "H_A_C_1_10_0", 0), ("softcluster", "H_A_C_1_10_0", 1),
    ("softcluster", "H_A_E_1_10_0", 2), ("softcluster", "H_B_C_2_10_5", 3),
    ("softcluster", "H_A_D_1_8_12", 4), ("softcluster", "mmacc_06", 0),
    ("softcluster", "mmacc_06", 5), ("softcluster", "hard", 1),
    ("softcluster", "softmax_3", 2), ("softcluster", "geni", 3),
    ("softclusterwin-1", "H_A_C_1_10_0", 4), ("softclusterwin-1", "hard", 5),
    ("softclusterreset", "softmax_3", 6)])
def test_same_decisions_from_same_accuracies(algo_name, arg, seed):
    from feddrift_tpu import obs as jobs
    jbus, bus = jobs.configure(None), tobs.configure(None)
    jalgo, algo = _pair(arg, seed, algo_name)
    for t in range(T):
        jbus.set_context(iteration=t)
        bus.set_context(iteration=t)
        _begin(jalgo, algo, t)
        _assert_same_state(jalgo, algo, t)
        assert algo.chunkable(t) and jalgo.chunkable(t)
    got, want = _events(bus), _events(jbus)
    assert got == want
    kinds = {e["kind"] for e in got}
    assert {"cluster_state", "cluster_assign"} <= kinds
    if algo.kind in ("hierarchical", "mmacc"):
        assert {"drift_detected", "cluster_create"} <= kinds
    if (arg, seed) == ("H_A_C_1_10_0", 0):
        assert "cluster_merge" in kinds
    if algo_name == "softclusterreset":
        assert "cluster_delete" in kinds
    if algo_name == "softclusterwin-1":
        assert not algo.weights[: T - 1].any()


def test_hard_r_reclusters_after_every_round():
    """IFCA with re-clustering: after_round takes the round's aggregate and
    re-assigns every client from a fresh accuracy matrix, round by round;
    the same sequence of matrices gives the same weights and events."""
    from feddrift_tpu import obs as jobs
    jbus, bus = jobs.configure(None), tobs.configure(None)
    jalgo, algo = _pair("hard-r", 7)
    for a in (jalgo, algo):
        rng = np.random.default_rng(70)       # the same draws for both
        a.acc_matrix_at = lambda t, feat_mask=None, rng=rng: rng.uniform(
            0.5, 1.0, (M, C))
    moves = 0
    for t in range(3):
        _begin(jalgo, algo, t)
        assert not algo.chunkable(t) and not jalgo.chunkable(t)
        for r in range(4):
            before = algo.weights[t].copy()
            jalgo.pool.params = jalgo.after_round(
                t, r, None, jalgo.pool.params, None, None)
            algo.pool.params = algo.after_round(
                t, r, None, algo.pool.params, None, None)
            _assert_same_state(jalgo, algo, t)
            moves += int((algo.weights[t] != before).any())
    assert moves > 0
    assert _events(bus) == _events(jbus)


def _cfl_updates(rng, algo, t, r, scale=1.0):
    """Scripted client updates of one round ``[M, C, P]`` and n ``[M, C]``:
    round 0 of step 0 all along one direction (it sets cfl_norm); later,
    each model's clients alternate +w_m / -w_m plus 1e-3 noise, so a
    cluster with an even count of participants has a small mean update and
    large client updates, and splits. One client a round sits out (n = 0)
    from round 2 on."""
    P = 26
    upd = rng.normal(0.0, 1e-3, (M, C, P)).astype(np.float32)
    n = np.zeros((M, C), np.float32)
    out = r % C if r >= 2 else -1
    if t == 0 and r == 0:
        upd[0] += scale * rng.standard_normal(P).astype(np.float32) / 5.0
    for m in range(M):
        clients = [c for c in np.nonzero(algo.weights[t, m])[0] if c != out]
        w = rng.standard_normal(P).astype(np.float32)
        w *= scale / np.linalg.norm(w)
        for i, c in enumerate(clients):
            if not (t == 0 and r == 0):
                upd[m, c] += w if i % 2 == 0 else -w
            n[m, c] = N
    return upd, n


def _cfl_trees(mod, prev, upd):
    """The same params as the port's dicts and the reference's flax trees:
    prev ``[M, P]``, client params ``prev + upd`` ``[M, C, P]``."""
    client = prev[:, None] + upd
    out = []
    for flat in (prev, client):
        d = mod.unpack(torch.from_numpy(np.ascontiguousarray(flat)))
        tree = {}
        for k, v in d.items():
            layer, leaf = k.split("/")
            tree.setdefault(layer, {})[leaf] = jnp.asarray(v.numpy())
        out.append((d, tree))
    return out


@pytest.mark.parametrize("arg", ["cfl_0.1_win-1", "cfl_0.1_all"])
def test_cfl_same_splits_from_same_client_updates(arg):
    from feddrift_tpu import obs as jobs
    jbus, bus = jobs.configure(None), tobs.configure(None)
    jalgo, algo = _pair(arg, 8)
    mod = algo.pool.module
    rng = np.random.default_rng(80)
    splits = 0
    for t in range(3):
        jbus.set_context(iteration=t)
        bus.set_context(iteration=t)
        _begin(jalgo, algo, t)
        _assert_same_state(jalgo, algo, t)
        assert not algo.chunkable(t) and algo.needs_client_params
        for r in range(5):
            prev = mod.pack(algo.pool.params).numpy()
            upd, n = _cfl_updates(rng, algo, t, r)
            (prev_d, prev_j), (cp_d, cp_j) = _cfl_trees(mod, prev, upd)
            jalgo.pool.params = jalgo.after_round(
                t, r, prev_j, prev_j, cp_j, jnp.asarray(n))
            algo.pool.params = algo.after_round(
                t, r, prev_d, prev_d, cp_d, torch.from_numpy(n))
            for k in ("cfl_norm", "cfl_eps1", "cfl_eps2"):
                assert getattr(algo, k) == pytest.approx(
                    getattr(jalgo, k), abs=1e-6), k
            _assert_same_state(jalgo, algo, t)
            splits = algo.h_next_free - 1
    assert splits == M - 1                     # the pool fills up
    if arg.endswith("_all"):
        assert np.array_equal(algo.weights[0], algo.weights[2])
    got, want = _events(bus), _events(jbus)
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    for a, b in zip(got, want):
        for k in a:
            if k in ("mean_norm", "max_norm", "alpha_cross"):
                assert a[k] == pytest.approx(b[k], abs=2e-6), k
            else:
                assert a[k] == b[k], k
    assert sum(e["kind"] == "cluster_split" for e in got) == M - 1


@pytest.mark.parametrize("arg", ["H_A_C_1_10_0", "mmacc_06",
                                 "cfl_0.1_win-1"])
def test_state_round_trip_continues_identically(arg):
    import pickle
    _, a = _pair(arg, 5)
    _, b = _pair(arg, 5)
    mod = a.pool.module
    rng = np.random.default_rng(50)

    def step(algo, t, rounds):
        algo.begin_iteration(t)
        for r, (upd, n) in enumerate(rounds):
            prev = mod.pack(algo.pool.params).numpy()
            (prev_d, _), (cp_d, _) = _cfl_trees(mod, prev, upd)
            algo.pool.params = algo.after_round(t, r, prev_d, prev_d, cp_d,
                                                torch.from_numpy(n))

    def script(t):
        return [_cfl_updates(rng, a, t, r) for r in range(4)] \
            if a.kind == "cfl" else []
    for t in range(3):
        rounds = script(t)
        step(a, t, rounds)
        step(b, t, rounds)
    state = pickle.loads(pickle.dumps(a.state_dict()))
    assert {"mmacc_acc", "cfl_norm", "cfl_eps1", "cfl_eps2", "h_next_free",
            "rng_state"} <= set(state)
    b.load_state_dict(state)
    b.pool.params = a.pool.params
    for t in range(3, T):
        rounds = script(t)
        step(a, t, rounds)
        step(b, t, rounds)
        assert np.array_equal(a.weights, b.weights)
        assert a.h_marked == b.h_marked
        assert (a.cfl_norm, a.h_next_free) == (b.cfl_norm, b.h_next_free)
        np.testing.assert_array_equal(a.mmacc_acc, b.mmacc_acc)


def test_state_from_before_cfl_loads():
    """A state dict written before CFL was ported (no cfl_* keys) loads,
    with the CFL state a fresh run starts from."""
    _, a = _pair("H_A_C_1_10_0", 5)
    _, b = _pair("cfl_0.1_win-1", 5)
    a.begin_iteration(0)
    state = {k: v for k, v in a.state_dict().items()
             if not k.startswith("cfl_")}
    b.cfl_norm, b.cfl_eps1, b.cfl_eps2 = 1.0, 2.0, 3.0
    b.load_state_dict(state)
    assert (b.cfl_norm, b.cfl_eps1, b.cfl_eps2) == (0.0, 0.0, 1e4)
    assert np.array_equal(a.weights, b.weights)
