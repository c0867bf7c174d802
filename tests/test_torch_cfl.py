"""CFL at SEA's full width against the reference, on the CPU.

CFL (``softcluster cfl_0.1_win-1``) splits a cluster when its clients'
updates of one round point apart, so which clients split off, and when,
turns on the initial params. At SEA's defaults (10 clients, N = B = 500)
every batch of a CFL pair is its whole step (CFL trains win-1: only the
current step carries weight), so from the same init both packages train on
the same data in every round, and their client updates agree to float32
rounding. From the reference's own init they then make the same first split, in the
same round, with the same clients, and put every client on the same model
at every eval until the next split.

Only the first split is robust to rounding, though: moving half of the
init's entries by one float32 ulp leaves it as it is, but splits other
clients later, and the reference's own later splits differ by CPU; so
later splits are held as decisions from the reference's state. ``chip_smoke.py`` pins the init (``CFL_REFERENCE_INIT``),
the first split (``CFL_FIRST_SPLIT``) and the per-step assignment
(``CFL_ASSIGNMENT``), holds the card's run to the first split and step 0's
assignment, and prints the rest beside the reference's; these tests are
where all three come from (``pytest -s`` prints the perturbed runs' splits).
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from feddrift_torch.config import ExperimentConfig
from feddrift_torch.convert import params_from_jax, pool_from_jax
from feddrift_torch.simulation.runner import Experiment
from torch_threads import one_intra_op_thread  # noqa: F401

ARG = "cfl_0.1_win-1"
SPLIT_KEYS = chip_smoke.SPLIT_KEYS


def _reference(**kw):
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.simulation.runner import Experiment as JExp
    return JExp(JCfg(concept_drift_algo_arg=ARG, **kw))


def _assignments(history):
    return [(r["iteration"], r["round"], chip_smoke._assignment(r))
            for r in history]


def test_pinned_init_is_the_references():
    """``CFL_REFERENCE_INIT`` is, bit for bit, the reference's reinit
    target for the canonical configuration, and every slot starts there."""
    jpool = _reference().pool
    want = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jpool.init_params), "cpu")
    assert set(want) == set(chip_smoke.CFL_REFERENCE_INIT)
    for key, value in want.items():
        pinned = torch.tensor(chip_smoke.CFL_REFERENCE_INIT[key],
                              dtype=torch.float32)
        assert torch.equal(pinned, value), key
    for key, value in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jpool.params), "cpu").items():
        assert torch.equal(value, want[key].expand_as(value)), key


CFL_STATE = ("cfl_norm", "cfl_eps1", "cfl_eps2", "h_next_free")


def _record_split_inputs(jexp):
    """Wrap the reference's ``after_round``: for every round that splits,
    keep the algorithm's state before the round and the round's inputs
    (round-start params, client params, n) as host copies."""
    algo, kept = jexp.algo, []
    orig = algo.after_round

    def after_round(t, r, prev_params, agg_params, client_params, n):
        before = (algo.weights.copy(), {k: getattr(algo, k) for k in
                                        CFL_STATE})
        count = len(jexp.events.events("cluster_split"))
        out = orig(t, r, prev_params, agg_params, client_params, n)
        if len(jexp.events.events("cluster_split")) > count:
            host = jax.tree_util.tree_map(
                np.asarray, (prev_params, client_params, n))
            kept.append((t, r, *before, *host, algo.weights.copy()))
        return out
    algo.after_round = after_round
    return kept


def test_canonical_run_splits_as_the_reference():
    """The canonical CFL run in both packages from the reference's pool.

    End to end, what holds on any CPU: the first ``cluster_split`` event
    is the reference's and ``CFL_FIRST_SPLIT`` (round, models and
    clients; the norms to float32 rounding), every client is on the same
    model at every eval until the reference's second split, step 0 ends
    on ``CFL_ASSIGNMENT[0]``, and step 0's accuracies track the
    reference's to 1e-4 as in ``test_torch_runner.py``.

    Later splits are held as decisions: at each round where the reference
    splits, the port's split test gets the reference's own state (the
    clustering weights and CFL's thresholds before the round, and the
    round's params, client params and n) and must split the same clients
    onto the same models. End to end they are not held: each round of the
    two packages agrees with float64 arithmetic to the same distance, but
    Adam's steps on tiny gradients amplify float32 rounding over 2000
    rounds, so which clients split later, and when, differs by CPU (for
    the reference itself too: round 230 on one, round 246 on another)."""
    jexp = _reference()
    splits_in = _record_split_inputs(jexp)
    exp = Experiment(ExperimentConfig(concept_drift_algo_arg=ARG),
                     device="cpu")
    exp.pool = exp.algo.pool = pool_from_jax(jexp.pool, exp.module, "cpu")
    jexp.run()
    exp.run()

    ref_splits = jexp.events.events("cluster_split")
    splits = exp.events.events("cluster_split")
    assert [splits[0][k] for k in SPLIT_KEYS] == \
        [ref_splits[0][k] for k in SPLIT_KEYS] == list(
            chip_smoke.CFL_FIRST_SPLIT)
    for key in ("mean_norm", "max_norm"):
        assert splits[0][key] == pytest.approx(ref_splits[0][key],
                                               abs=2e-6), key
    assert splits[0]["alpha_cross"] == pytest.approx(
        ref_splits[0]["alpha_cross"], abs=2e-4)

    ours, ref = exp.logger.history, jexp.logger.history
    until = ref_splits[1]["round"] if len(ref_splits) > 1 else 10 ** 9
    through = [i for i, r in enumerate(ref) if r["round"] < until]
    assert [_assignments(ours)[i] for i in through] == \
        [_assignments(ref)[i] for i in through]
    final = {r["iteration"]: chip_smoke._assignment(r) for r in ours}
    assert final[0] == list(chip_smoke.CFL_ASSIGNMENT[0])
    step0 = [(a, b) for a, b in zip(ours, ref) if a["iteration"] == 0]
    assert len(step0) == 41
    for a, b in step0:
        for key in a:
            if "Acc" in key:
                assert a[key] == pytest.approx(b[key], abs=1e-4), key

    # every reference split, decided again by the port from its state
    assert len(splits_in) == len(ref_splits) >= 2
    algo, mod = exp.algo, exp.module
    for t, r, weights, state, prev, client, n, after in splits_in:
        algo.weights = weights.copy()
        for k, v in state.items():
            setattr(algo, k, v)
        algo.pool.params = params_from_jax(prev, "cpu")
        did = algo._cluster_cfl_round(
            t, params_from_jax(prev, "cpu"), params_from_jax(client, "cpu"),
            torch.from_numpy(np.array(n)))
        assert did, (t, r)
        assert np.array_equal(algo.weights[t], after[t]), (t, r)
        assert algo.h_next_free == state["h_next_free"] + 1


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_first_split_survives_one_ulp(seed):
    """From the pinned init with half of its kernel entries moved one ulp
    up or down, the port's first split and step 0's assignment stay the
    reference's; what follows may not (printed)."""
    exp = Experiment(ExperimentConfig(concept_drift_algo_arg=ARG,
                                      train_iterations=2), device="cpu")
    rng = np.random.default_rng(seed)
    init = {}
    for key, value in chip_smoke.CFL_REFERENCE_INIT.items():
        a = np.array(value, dtype=np.float32)
        if "kernel" in key:
            moved = rng.random(a.shape) < 0.5
            away = np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf)
            a = np.where(moved, np.nextafter(a, away.astype(np.float32)), a)
        init[key] = torch.from_numpy(a)
    exp.pool.init_params = init
    exp.pool.params = {k: v[None].expand(exp.pool.num_models, *v.shape)
                       .clone() for k, v in init.items()}
    exp.run()
    splits = [[e[k] for k in SPLIT_KEYS]
              for e in exp.events.events("cluster_split")]
    final = {r["iteration"]: chip_smoke._assignment(r)
             for r in exp.logger.history}
    print(f"seed {seed}: splits {splits}, assignment {final}")
    assert splits[0] == list(chip_smoke.CFL_FIRST_SPLIT)
    assert final[0] == list(chip_smoke.CFL_ASSIGNMENT[0])


def _rounds_against_float64(T=10):
    """Each round of the reference's canonical CFL run, fed to the port's
    ``train_round`` as it is (params, optimizer state, weights; every
    batch is the whole current step) and to the port in float64: the
    largest client-params difference of the two packages, and of each
    from float64 arithmetic, over the active pairs."""
    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.models.mlp import FeedForwardNN
    jexp = _reference(train_iterations=T)
    mod = FeedForwardNN((3,), 2, 10)
    steps = {d: TrainStep(mod, 500, 5, 2, lr=0.01, wd=0.001, device="cpu")
             for d in ("f32", "f64")}
    orig, worst = jexp.step.train_round, [0.0, 0.0, 0.0]

    def packed(tree):
        return mod.pack(params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree), "cpu"))

    def wrapped(params, opt, key, x, y, tw, *a, **k):
        out = orig(params, opt, key, x, y, tw, *a, **k)
        tw = np.asarray(tw)
        M, C, _ = tw.shape
        t = int(np.argmax(tw.sum((0, 1))))
        st = opt[1][0]
        state = {"mu": packed(st.mu), "nu": packed(st.nu),
                 "nu_max": packed(st.nu_max),
                 "count": torch.from_numpy(np.array(st.count, np.int32))}
        p = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
        draws = (torch.full((M, C, 5), t, dtype=torch.int32),
                 torch.zeros((M, C, 5), dtype=torch.int32))
        xt, yt = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
        got = {}
        for d, step in steps.items():
            cast = (lambda v: v.double()) if d == "f64" else (lambda v: v)
            got[d] = mod.pack(step.train_round(
                {n: cast(v) for n, v in p.items()},
                {n: cast(v) if v.is_floating_point() else v
                 for n, v in state.items()}, cast(xt), yt,
                cast(torch.from_numpy(tw)), 1.0, draws=draws)[2])
        ref = packed(out[2])
        act = torch.from_numpy(tw.sum(-1) > 0)
        for i, diff in enumerate((ref - got["f32"], ref.double() - got["f64"],
                                  got["f32"].double() - got["f64"])):
            worst[i] = max(worst[i], float(diff[act].abs().max()))
        return out
    jexp.step.train_round = wrapped
    jexp.run()
    print(f"max |reference - port|: {worst[0]}; max |reference - float64|: "
          f"{worst[1]}; max |port - float64|: {worst[2]}")
    print(f"the reference's splits: "
          f"{[[e[k] for k in SPLIT_KEYS] for e in jexp.events.events('cluster_split')]}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_cfl.py: how far one round of each package is
    # from float64 arithmetic, fed the reference's own inputs
    _rounds_against_float64()
