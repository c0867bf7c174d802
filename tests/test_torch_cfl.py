"""CFL at SEA's full width against the reference, on the CPU.

CFL (``softcluster cfl_0.1_win-1``) splits a cluster when its clients'
updates of one round point apart, so which clients split off, and when,
turns on the initial params. At SEA's defaults (10 clients, N = B = 500)
every batch of a CFL pair is its whole step (CFL trains win-1: only the
current step carries weight), so from the same init both packages train on
the same data in every round, and their client updates agree to float32
rounding. From the reference's own init they then make the same splits, in
the same rounds, with the same clients, and put every client on the same
model at every eval of the canonical run (T = 10, R = 200).

Only the first split is robust to rounding, though: moving half of the
init's entries by one float32 ulp leaves it as it is, but splits other
clients later. ``chip_smoke.py`` pins the init (``CFL_REFERENCE_INIT``),
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


def test_canonical_run_splits_as_the_reference():
    """The canonical CFL run in both packages from the reference's pool:
    the same ``cluster_split`` events (round, models and clients; the norms
    to float32 rounding), every client on the same model at every eval,
    and that assignment at each step's final eval is ``CFL_ASSIGNMENT``.
    Step 0, split included, tracks the reference's accuracies to float32
    rounding as in ``test_torch_runner.py``; later steps only the
    decisions, as the evals drift apart by a few test samples over the
    2000 rounds."""
    jexp = _reference()
    exp = Experiment(ExperimentConfig(concept_drift_algo_arg=ARG),
                     device="cpu")
    exp.pool = exp.algo.pool = pool_from_jax(jexp.pool, exp.module, "cpu")
    jexp.run()
    exp.run()

    ref_splits = jexp.events.events("cluster_split")
    splits = exp.events.events("cluster_split")
    assert [[e[k] for k in SPLIT_KEYS] for e in splits] == \
        [[e[k] for k in SPLIT_KEYS] for e in ref_splits]
    assert len(splits) == 2
    assert [splits[0][k] for k in SPLIT_KEYS] == list(
        chip_smoke.CFL_FIRST_SPLIT)
    for a, b in zip(splits, ref_splits):
        assert a["alpha_cross"] == pytest.approx(b["alpha_cross"], abs=2e-4)
        for key in ("mean_norm", "max_norm"):
            assert a[key] == pytest.approx(b[key], abs=2e-6), key

    ours, ref = exp.logger.history, jexp.logger.history
    assert _assignments(ours) == _assignments(ref)
    final = {r["iteration"]: chip_smoke._assignment(r) for r in ours}
    assert [final[t] for t in sorted(final)] == \
        [list(a) for a in chip_smoke.CFL_ASSIGNMENT]
    step0 = [(a, b) for a, b in zip(ours, ref) if a["iteration"] == 0]
    assert len(step0) == 41
    for a, b in step0:
        for key in a:
            if "Acc" in key:
                assert a[key] == pytest.approx(b[key], abs=1e-4), key


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
