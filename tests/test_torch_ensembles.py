"""The streaming ensembles (``algorithms/ensembles.py``: AUE, AUE-PC, KUE)
and the device functions they read (``TrainStep.ensemble_eval``,
``mse_matrix``, ``confusion_matrices``, ``core/functional.py::
confusion_matrix``) against the JAX package on the CPU.

- The device functions on the same params and data: the vote's correct
  counts and the confusion matrices exactly, the vote's NLL and the Brier
  sums to 1e-5 relative (float32 sums over 40 rows in another order).
- Decisions from the same matrices (parity level 1): AUE's and AUE-PC's
  weights and window, KUE's kappas, worst model, feature masks and
  Poisson counts; the masks and counts come from the reference's own
  stream (``default_rng(seed + 31337)``), so they agree bit for bit.
- A 2-step run of each in both packages from the reference's pool on the
  reference's draws (``test_torch_statebased.run_both``; its tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddrift_torch.convert import params_from_jax
from feddrift_torch.core.functional import confusion_matrix
from feddrift_torch.core.step import TrainStep
from feddrift_torch.data.retrain import poisson_sample_counts
from feddrift_torch.models.mlp import FeedForwardNN
from test_torch_statebased import _pair, assert_runs_agree, run_both
from torch_threads import one_intra_op_thread  # noqa: F401

M, C, N, F, K = 3, 4, 40, 3, 2


def _both(seed=0):
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (C, N, F)).astype(np.float32)
    y = (x[..., 0] + 0.3 * rng.standard_normal((C, N)) > 0.5).astype(np.int32)
    jm = JFnn(num_classes=K, hidden_dim=6)
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    jp = jax.vmap(lambda k: jm.init(k, jnp.zeros((1, F)))["params"])(keys)
    jstep = JStep(lambda p, xx: jm.apply({"params": p}, xx),
                  make_optimizer("adam", 0.01, 0.001), 20, 2, K)
    step = TrainStep(FeedForwardNN((F,), K, 6), 20, 2, K, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    fm = (rng.random((M, F)) < 0.6).astype(np.float32)
    fm[:, 0] = 1.0
    return x, y, jp, jstep, params, step, fm


@pytest.mark.parametrize("mode,per_client,masked", [
    ("hard", False, False), ("hard", True, True), ("soft", False, True),
    ("soft", True, False)])
def test_ensemble_eval_matches_reference(mode, per_client, masked):
    x, y, jp, jstep, params, step, fm = _both(1)
    rng = np.random.default_rng(2)
    w = rng.uniform(-0.2, 1.0, (M, C) if per_client else (M,)) \
        .astype(np.float32)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    got = step.ensemble_eval(params, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(w), mode,
                             torch.from_numpy(mask) if masked else None,
                             torch.from_numpy(fm))
    want = jstep.ensemble_eval(jp, jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(w), mode,
                               jnp.asarray(mask) if masked else None,
                               jnp.asarray(fm))
    assert got[0].dtype == torch.int32
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)


def test_mse_and_confusion_matrices_match_reference():
    x, y, jp, jstep, params, step, fm = _both(3)
    tx, ty, tfm = (torch.from_numpy(a) for a in (x, y, fm))
    mse, total = step.mse_matrix(params, tx, ty, tfm)
    jmse, jtotal = jstep.mse_matrix(jp, jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(fm))
    np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=1e-5)
    assert np.array_equal(total.numpy(), np.asarray(jtotal))
    cms = step.confusion_matrices(params, tx, ty, tfm)
    jcms = jstep.confusion_matrices(jp, jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(fm))
    assert cms.dtype == torch.float32 and cms.shape == (M, C, K, K)
    assert np.array_equal(cms.numpy(), np.asarray(jcms))
    assert (cms.sum((-1, -2)) == N).all()


def test_confusion_matrix_matches_reference():
    from feddrift_tpu.core.functional import confusion_matrix as jcm
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((50, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 50).astype(np.int32)
    got = confusion_matrix(torch.from_numpy(logits), torch.from_numpy(labels),
                           4)
    assert np.array_equal(got.numpy(), np.asarray(
        jcm(jnp.asarray(logits), jnp.asarray(labels), 4)))


def test_kappa_and_poisson_counts_match_reference():
    from feddrift_tpu.algorithms.ensembles import kappa_from_confusion as jk
    from feddrift_tpu.data.retrain import poisson_sample_counts as jpc

    from feddrift_torch.algorithms.ensembles import kappa_from_confusion
    rng = np.random.default_rng(5)
    for _ in range(20):
        A = rng.integers(0, 30, (3, 3)).astype(np.float64)
        assert kappa_from_confusion(A) == jk(A)
    assert kappa_from_confusion(np.diag([5.0, 0.0])) == jk(np.diag([5.0, 0.0]))
    a, b = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(3):
        got, want = poisson_sample_counts(5, 3, a), jpc(5, 3, b)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert (got.sum(1) > 0).all()


def _mse_table(rng, M_, C_, steps):
    return {t: (rng.uniform(10, 90, (M_, C_)).astype(np.float32),
                np.full(C_, 100, np.int32)) for t in range(steps)}


@pytest.mark.parametrize("algo", ["aue", "auepc"])
def test_aue_weights_as_the_reference(algo):
    """The same MSE matrices: the same window, model rotation, weights and
    ensemble spec every round."""
    port, ref = _pair(algo)
    table = _mse_table(np.random.default_rng(7), port.M, port.C, 6)
    port.step.mse_matrix = lambda p, x, y, fm=None: tuple(
        torch.from_numpy(a) for a in table[port._t])
    ref.step.mse_matrix = lambda p, x, y, fm: tuple(
        jnp.asarray(a) for a in table[port._t])
    for t in range(6):
        port._t = t
        port.begin_iteration(t)
        ref.begin_iteration(t)
        assert port.model_num == ref.model_num
        assert np.array_equal(port.round_inputs(t, 0)[0].numpy(),
                              np.asarray(ref.round_inputs(t, 0)[0]))
        for r in (0, 5, 10, 11):
            port.after_round(t, r, None, port.pool.params, None, None)
            ref.after_round(t, r, None, ref.pool.params, None, None)
            assert np.array_equal(port.ens_weights, ref.ens_weights), (t, r)
        a, b = port.ensemble_spec(t), ref.ensemble_spec(t)
        assert a.mode == b.mode == "hard"
        assert np.array_equal(a.weights, b.weights)
        assert np.array_equal(a.model_mask, b.model_mask)


def test_kue_kappas_masks_and_counts_as_the_reference():
    """The same confusion matrices: the same kappas and worst model; the
    re-masked model, every mask and every Poisson count bit for bit (one
    random stream in both), and the soft-vote spec."""
    port, ref = _pair("kue")
    assert port.uses_sample_weights and ref.uses_sample_weights
    assert np.array_equal(port.masks, ref.masks)
    rng = np.random.default_rng(8)
    K_ = port.ds.num_classes
    for t in range(5):
        cms = rng.integers(0, 40, (port.M, port.C, K_, K_)).astype(np.float32)
        port.step.confusion_matrices = lambda *a, c=cms: torch.from_numpy(c)
        ref.step.confusion_matrices = lambda *a, c=cms: jnp.asarray(c)
        port.begin_iteration(t)
        ref.begin_iteration(t)
        tw, sw, fm, _ = port.round_inputs(t, 0)
        jtw, jsw, jfm, _ = ref.round_inputs(t, 0)
        assert np.array_equal(tw.numpy(), np.asarray(jtw))
        assert np.array_equal(sw.numpy(), np.asarray(jsw))
        assert np.array_equal(fm.numpy(), np.asarray(jfm))
        for r in (0, 10, 11):
            port.after_round(t, r, None, port.pool.params, None, None)
            ref.after_round(t, r, None, ref.pool.params, None, None)
        assert np.array_equal(port.ens_weights, ref.ens_weights)
        assert port.worst_idx == ref.worst_idx
        a, b = port.ensemble_spec(t), ref.ensemble_spec(t)
        assert a.mode == b.mode == "soft"
        assert np.array_equal(a.weights, b.weights)
        assert np.array_equal(a.model_mask, b.model_mask)
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


@pytest.mark.parametrize("algo", ["aue", "auepc", "kue"])
def test_two_steps_track_the_reference(algo):
    exp, jexp = run_both(algo)
    assert_runs_agree(exp, jexp)
    if algo == "kue":
        assert exp.step.weighted_sampling
        assert np.array_equal(exp.algo.masks, jexp.algo.masks)
