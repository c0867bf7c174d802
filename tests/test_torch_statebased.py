"""The state-machine algorithms (``algorithms/statebased.py``: DriftSurf,
MultiModel ``mmacc`` / ``mmgeni`` / ``mmgeniex``, Adaptive-FedAvg and the
legacy ClusterFL) against the JAX package on the CPU.

Parity level 1 (ROADMAP): given the same accuracies, parameters or client
updates, each algorithm makes the reference's decisions: DriftSurf's state
transitions and retrain windows, MultiModel's selection and spawns, Ada's
eta series, ClusterFL's split (against scikit-learn's clustering, which the
reference calls and the port does not) and its re-aggregated models.

End to end: a 2-step run of each in both packages from the reference's
initial pool, the port handed the reference's own batch draws (its
``fold_in(iteration_key(t), r)`` keys, turned into indices as the
reference's ``_local_sgd`` does), so both train on the same batches: every
eval's model assignment is equal and its accuracies agree within 2e-3 (two
of the 1000 samples an eval scores; the two packages sum in other orders,
so a sample on a decision boundary may flip), the losses within 1e-2.
``run_both`` is shared with ``test_torch_ensembles.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.convert import params_from_jax, pool_from_jax
from feddrift_torch.simulation.runner import Experiment
from torch_threads import one_intra_op_thread  # noqa: F401

SMALL = dict(train_iterations=2, comm_round=12, frequency_of_the_test=4,
             sample_num=100, batch_size=50)
ACC_TOL, LOSS_TOL = 2e-3, 1e-2


# ----------------------------------------------------------------------
# both packages, the reference's draws injected into the port

def _reference_draws(key, time_w, S, B, N, weighted):
    """One round's draws of the reference from its round key: ``(t_idx,
    slot)`` ``[M, C, S]`` for contiguous batches, the uniforms ``[M, C, S,
    B]`` of ``inverse_cdf_draw`` with weighted sampling."""
    M, C = time_w.shape[:2]
    keys = jax.random.split(key, M * C).reshape(M, C, 2)

    def pair(k, w):
        w_safe = jnp.where(w.sum() > 0, w, jnp.ones_like(w))
        logits = jnp.log(w_safe + 1e-30)

        def one(kk):
            k1, k2 = jax.random.split(kk)
            if weighted:
                return jax.random.uniform(k1, (B,))
            return (jax.random.categorical(k1, logits),
                    jax.random.randint(k2, (), 0, N // B))
        return jax.vmap(one)(jax.random.split(k, S))
    out = jax.vmap(jax.vmap(pair))(keys, jnp.asarray(time_w))
    if weighted:
        return torch.from_numpy(np.array(out, np.float32))
    return tuple(torch.from_numpy(np.array(a, np.int32)) for a in out)


def run_both(algo, arg="", **kw):
    """The same configuration in both packages, the port from the
    reference's pool and on the reference's draws; returns (port
    Experiment, reference Experiment), both run."""
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.simulation.runner import Experiment as JExp
    from feddrift_tpu.utils.prng import iteration_key
    cfg = dict(SMALL, concept_drift_algo=algo, concept_drift_algo_arg=arg,
               **kw)
    jexp = JExp(JCfg(**cfg))
    exp = Experiment(ExperimentConfig(**cfg), device="cpu")
    exp.pool = exp.algo.pool = pool_from_jax(jexp.pool, exp.module, "cpu")
    step, R = exp.step, cfg["comm_round"]
    N, B, S = exp.x.shape[2], min(cfg["batch_size"], exp.x.shape[2]), \
        step.num_steps
    weighted = step.weighted_sampling

    def draws(t, r, tw):
        # the reference pads the client axis to its mesh (C_pad) with
        # zero-weight clients, and splits its keys over all of them
        key = jax.random.fold_in(iteration_key(jexp.key, t), r)
        tw = tw.numpy()
        pad = np.zeros((tw.shape[0], jexp.C_pad, tw.shape[2]), np.float32)
        pad[:, : tw.shape[1]] = tw
        got = _reference_draws(key, pad, S, B, N, weighted)
        C = tw.shape[1]
        return got[:, :C].contiguous() if weighted \
            else tuple(a[:, :C].contiguous() for a in got)

    train_round, iteration = step.train_round, step.train_iteration_eval

    def round_(params, opt, x, y, tw, lr_scale=1.0, client_mask=None, **k):
        t, r = divmod(exp.global_round, R)
        k["draws"] = draws(t, r, tw)
        return train_round(params, opt, x, y, tw, lr_scale, client_mask, **k)

    def fused(params, opt, x, y, tw, lr_scale, R_, freq, t, masks=None, **k):
        per = [draws(t, r, tw) for r in range(R_)]
        k["draws"] = torch.stack(per) if weighted else tuple(
            torch.stack([d[i] for d in per]) for i in (0, 1))
        return iteration(params, opt, x, y, tw, lr_scale, R_, freq, t, masks,
                         **k)
    step.train_round, step.train_iteration_eval = round_, fused
    jexp.run()
    exp.run()
    return exp, jexp


def assert_runs_agree(exp, jexp):
    ours, ref = exp.logger.history, jexp.logger.history
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert (a["iteration"], a["round"]) == (b["iteration"], b["round"])
        for key in b:
            if key == "_ts":
                continue
            if "Acc" in key:
                assert a[key] == pytest.approx(b[key], abs=ACC_TOL), key
            elif "Loss" in key:
                assert a[key] == pytest.approx(b[key], abs=LOSS_TOL), key
            else:
                assert a[key] == b[key], key


@pytest.mark.parametrize("algo,arg", [
    ("driftsurf", ""), ("mmacc", "mmacc_06"), ("mmgeni", ""),
    ("mmgeniex", ""), ("ada", "win-1_iter"), ("ada", "win-1_round"),
    ("clusterfl", "")])
def test_two_steps_track_the_reference(algo, arg):
    exp, jexp = run_both(algo, arg)
    assert_runs_agree(exp, jexp)


# ----------------------------------------------------------------------
# decisions from the same inputs (level 1)

def _pair(algo, arg="", **kw):
    """The algorithm of both packages, the port's over the reference's
    initial pool."""
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.simulation.runner import Experiment as JExp
    cfg = dict(SMALL, concept_drift_algo=algo, concept_drift_algo_arg=arg,
               train_iterations=8, **kw)
    jexp = JExp(JCfg(**cfg))
    exp = Experiment(ExperimentConfig(**cfg), device="cpu")
    exp.pool = exp.algo.pool = pool_from_jax(jexp.pool, exp.module, "cpu")
    return exp.algo, jexp.algo


def _scripted(table):
    """A stand-in for an accuracy source: ``table[t]`` at step t."""
    return lambda t, *a: table[t]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_driftsurf_transitions_as_the_reference(seed):
    """The same scores for every (key, step) drive both state machines
    through stab -> reac -> stab: states, keys, windows, the test model and
    the time weights agree at every step."""
    port, ref = _pair("driftsurf")
    rng = np.random.default_rng(seed)
    scores = {(k, t): float(v) for t in range(8) for k, v in zip(
        ("pred", "stab", "reac"), rng.uniform(0.5, 0.95, 3))}
    # a drop at step 3 makes the drift detector fire
    scores[("pred", 3)] = 0.3
    for algo in (port, ref):
        algo._score = lambda key, t, a=algo: 0.0 \
            if a.key_params[key] is None else scores[(key, t)]
    for t in range(8):
        port.begin_iteration(t)
        ref.begin_iteration(t)
        for k in ("state", "train_keys", "train_data", "model_key",
                  "reac_ctr"):
            assert getattr(port, k) == getattr(ref, k), (k, t)
        assert port.acc_best == ref.acc_best
        assert np.array_equal(port.round_inputs(t, 0)[0].numpy(),
                              np.asarray(ref.round_inputs(t, 0)[0]))
        assert np.array_equal(port.test_model_idx(t), ref.test_model_idx(t))
        port.end_iteration(t)
        ref.end_iteration(t)
    assert ref.state == "stab" and "reac" in ref.train_data


@pytest.mark.parametrize("algo", ["mmacc", "mmgeni", "mmgeniex"])
def test_multimodel_selects_as_the_reference(algo):
    """The same [M, C] accuracies each step (mmacc), or the concept matrix
    (the oracles): the same train and test models, windows, spawns and time
    weights."""
    port, ref = _pair(algo, "mmacc_06" if algo == "mmacc" else "")
    rng = np.random.default_rng(3)
    table = {t: rng.uniform(0.4, 0.95, (port.M, port.C)) for t in range(8)}
    table[4][:, :3] = 0.2                   # clients 0-2 drift at step 4
    for algo_ in (port, ref):
        algo_.acc_matrix_at = _scripted(table)
    for t in range(7):
        port.begin_iteration(t)
        ref.begin_iteration(t)
        assert port.train_data == ref.train_data, t
        assert np.array_equal(port.train_model_idx(t), ref.train_model_idx(t))
        assert np.array_equal(port.test_model_idx(t), ref.test_model_idx(t))
        assert np.array_equal(port.round_inputs(t, 0)[0].numpy(),
                              np.asarray(ref.round_inputs(t, 0)[0]))
        port.end_iteration(t)
        ref.end_iteration(t)
        assert np.array_equal(port.acc_dict, ref.acc_dict)
    if algo == "mmacc":
        assert len(port._assigned()) > 1     # the drift spawned a model


@pytest.mark.parametrize("arg", ["win-1_round", "win-1_iter", "all_round"])
def test_ada_eta_series_as_the_reference(arg):
    """The same aggregated params each round: the same eta, hence the same
    lr_scale, and the same moment state, over three steps of rounds."""
    port, ref = _pair("ada", arg)
    rng = np.random.default_rng(4)
    R = SMALL["comm_round"]
    jp = jax.tree_util.tree_map(np.asarray, ref.pool.params)
    for t in range(3):
        port.begin_iteration(t)
        ref.begin_iteration(t)
        assert np.array_equal(port.round_inputs(t, 0)[0].numpy(),
                              np.asarray(ref.round_inputs(t, 0)[0]))
        for r in range(R):
            jp = jax.tree_util.tree_map(
                lambda a: (a + 0.05 * rng.standard_normal(a.shape))
                .astype(np.float32), jp)
            port.after_round(t, r, None, params_from_jax(jp, "cpu"), None,
                             None)
            ref.after_round(t, r, None, jax.tree_util.tree_map(
                jnp.asarray, jp), None, None)
            assert port.eta == ref.eta, (t, r)
            assert port.round_inputs(t, r)[3] == float(
                ref.round_inputs(t, r)[3])
        assert port.s == ref.s and port.gam == ref.gam
        assert np.array_equal(port.mu, ref.mu)


def _updates(rng, P_shape, C, split):
    """Client updates: clients 0-3 along d and the others along -d when
    ``split`` (two groups pointing apart), all along d otherwise, plus a
    little noise."""
    d = rng.standard_normal(P_shape).astype(np.float32)
    out = np.stack([d if (c < 4 or not split) else -d for c in range(C)])
    return out + 0.01 * rng.standard_normal(out.shape).astype(np.float32)


@pytest.mark.parametrize("seed", [5, 6])
def test_clusterfl_splits_as_the_reference(seed):
    """The same client updates every round: the norm gate opens after
    round 100 and both split the same clients (scikit-learn's labels in the
    reference, ``bipartition_labels`` in the port), re-aggregate the same
    two models from the round's uploads, and stop testing afterwards."""
    port, ref = _pair("clusterfl")
    rng = np.random.default_rng(seed)
    port.begin_iteration(0)
    ref.begin_iteration(0)
    mod = port.pool.module
    jprev = jax.tree_util.tree_map(np.asarray, ref.pool.params)
    prev = params_from_jax(jprev, "cpu")
    flat = mod.pack(prev)
    M, C = port.M, port.C
    n = np.full((M, C), 100.0, np.float32)
    n[1:] = 0.0
    n[0, [7, 9]] = 0.0                      # two clients that sat out
    for r, (scale, split) in enumerate([(1.0, False)] + [(0.1, False)] * 50
                                       + [(1.0, True)] * 60):
        upd = scale * _updates(rng, flat.shape[1:], C, split)
        client = flat[:, None] + torch.from_numpy(upd)[None]
        cp = mod.unpack(client)
        jcp = jax.tree_util.tree_map(
            jnp.asarray, {k: v for k, v in _as_tree(cp, jprev).items()})
        port.after_round(0, r, prev, prev, cp, torch.from_numpy(n))
        ref.after_round(0, r, jax.tree_util.tree_map(jnp.asarray, jprev),
                        jax.tree_util.tree_map(jnp.asarray, jprev), jcp,
                        jnp.asarray(n))
        assert port.is_split == ref.is_split, r
        assert np.array_equal(port.assignment, ref.assignment), r
        assert (port.eps1, port.eps2, port.max_eps1) == pytest.approx(
            (ref.eps1, ref.eps2, ref.max_eps1), rel=1e-6), r
        if port.is_split:
            break
    assert port.is_split and r > 100
    assert sorted(set(port.assignment.tolist())) == [0, 1]
    got = mod.pack(port.pool.params)
    want = mod.pack(params_from_jax(jax.tree_util.tree_map(
        np.asarray, ref.pool.params), "cpu"))
    assert torch.equal(got[:2], want[:2])


def _as_tree(flat_dict, like):
    """The port's flat leaves as the reference's nested tree."""
    out = {}
    for key, value in flat_dict.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.numpy()
    return out


def test_bipartition_labels_are_scikit_learns():
    import warnings

    from sklearn.cluster import AgglomerativeClustering

    from feddrift_torch.algorithms.statebased import bipartition_labels
    for seed in range(60):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 11))
        dW = rng.standard_normal((n, 62)).astype(np.float32)
        norms = np.linalg.norm(dW, axis=1)
        S = (dW @ dW.T) / (np.outer(norms, norms) + 1e-12)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = AgglomerativeClustering(
                metric="precomputed", linkage="complete",
                n_clusters=2).fit(-S).labels_
        assert np.array_equal(bipartition_labels(S), want), seed


def test_state_round_trips():
    """Each algorithm's state_dict loads into a fresh instance."""
    for algo, arg in (("driftsurf", ""), ("mmacc", "mmacc_06"),
                      ("ada", "win-1_round"), ("clusterfl", "")):
        port, _ = _pair(algo, arg)
        port.begin_iteration(0)
        port.end_iteration(0)
        again, _ = _pair(algo, arg)
        again.load_state_dict(port.state_dict())
        assert repr(again.state_dict()) == repr(port.state_dict()), algo


def _full_width_decisions(algo, arg=""):
    """A full-width run (SEA's defaults: T = 10, R = 200, N = B = 500) in
    both packages on the reference's draws: each one's drift and split
    events and whether every eval put every client on the same model. For
    ``clusterfl``, each round where the port splits is also handed to the
    reference's split test with the port's state and inputs."""
    splits = []
    if algo == "clusterfl":
        from feddrift_torch.algorithms import statebased

        orig = statebased.LegacyClusterFL.after_round

        def after_round(self, t, r, prev, agg, client, n):
            state = (self.is_split, self.assignment.copy(), self.eps1,
                     self.eps2, self.max_eps1)
            out = orig(self, t, r, prev, agg, client, n)
            if self.is_split and not state[0]:
                splits.append((t, r, state, *(
                    {k: v.numpy().copy() for k, v in tree.items()}
                    for tree in (prev, client)), n.numpy().copy(),
                    self.assignment.copy()))
            return out
        statebased.LegacyClusterFL.after_round = after_round
    exp, jexp = run_both(algo, arg, train_iterations=10, comm_round=200,
                         sample_num=500, batch_size=500,
                         frequency_of_the_test=5)
    for t, r, state, prev, client, n, after in splits:
        ref = jexp.algo
        (ref.is_split, ref.assignment, ref.eps1, ref.eps2,
         ref.max_eps1) = (False, state[1].copy(), *state[2:])
        tree = lambda flat: jax.tree_util.tree_map(jnp.asarray, _as_tree(
            {k: torch.from_numpy(v) for k, v in flat.items()}, None))
        ref.after_round(t, r, tree(prev), tree(prev), tree(client),
                        jnp.asarray(n))
        print(f"clusterfl: the port split at step {t}, round {r}; the "
              f"reference's split test on the port's state and inputs "
              f"splits: {ref.is_split}, the same clients: "
              f"{np.array_equal(ref.assignment, after)}")
    ours, ref = exp.logger.history, jexp.logger.history
    plural = [[[r[f"Plurality/CL-{c}"] for c in range(exp.C_)]
               for r in h] for h in (ours, ref)]
    print(f"{algo} {arg}: every eval the same assignment: "
          f"{plural[0] == plural[1]}; max |Test/Acc difference|: "
          f"{max(abs(a['Test/Acc'] - b['Test/Acc']) for a, b in zip(ours, ref))}")
    for name, e in (("port", exp), ("reference", jexp)):
        final = {r["iteration"]: r for r in e.logger.history}
        print(f"  {name}: per-step assignment "
              f"{[[final[t][f'Plurality/CL-{c}'] for c in range(exp.C_)] for t in sorted(final)]}")
        print(f"  {name}: drift_detected at "
              f"{[(v['iteration'], v['round']) for v in e.events.events('drift_detected')]}")
    print(f"  port: cluster_split at "
          f"{[(v['iteration'], v['round']) for v in exp.events.events('cluster_split')]}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_statebased.py driftsurf [arg]:
    # where the card departs from a committed run, whether the packages
    # decide alike on the same draws
    import sys
    _full_width_decisions(*sys.argv[1:3])
