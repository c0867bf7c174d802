"""``debug_checks`` in both packages, and the port's copy of
``utils/invariants.py``.

The reference turns on ``jax_debug_nans``: a NaN raises
``FloatingPointError`` in the program that produced it. The port checks
each device program's outputs of a round for NaN right after it runs and
raises ``FloatingPointError`` naming the program. Held on the blow-up
configuration (``chip_smoke.BLOWUP_RUN``'s lr 1e20, shortened to 2 steps
of 5 rounds): both packages raise with the checks on and roll back through
the divergence guard with them off. The reference's global flag is
restored after each of its runs, as ``tests/test_invariants.py`` does.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_intra_op_thread  # noqa: F401

BLOWUP = dict(train_iterations=2, comm_round=5, lr=1e20)


def _reference(kw):
    import jax
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.simulation.runner import Experiment as JExp
    exp = JExp(JCfg(**kw))
    try:
        exp.run()
    finally:
        jax.config.update("jax_debug_nans", False)
    return exp


def _port(kw):
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    exp = Experiment(ExperimentConfig(**kw), device="cpu")
    exp.run()
    return exp


@pytest.mark.parametrize("chunk", [True, False], ids=["fused", "per_round"])
def test_blowup_raises_with_debug_checks(chunk):
    kw = dict(BLOWUP, debug_checks=True, chunk_rounds=chunk)
    with pytest.raises(FloatingPointError, match="nan"):
        _reference(kw)
    with pytest.raises(FloatingPointError) as got:
        _port(kw)
    msg = str(got.value)
    assert "K1 (local_sgd_fedavg)" in msg and "nan" in msg


def test_blowup_rolls_back_without_debug_checks():
    kw = dict(BLOWUP, train_iterations=1)       # one step: one rollback
    ref, ours = _reference(kw), _port(kw)
    reasons = lambda e: [ev["reason"] for ev in
                         e.events.events("divergence_detected")]
    assert reasons(ours) == reasons(ref) == ["nonfinite"]
    assert ours.global_round == ref.global_round == 5


def test_debug_checks_validate_the_round_inputs():
    """Under ``debug_checks`` each step's round inputs go through the
    reference's ``check_round_inputs`` (None weights and masks are
    ones)."""
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.simulation.runner import Experiment
    from feddrift_torch.utils.invariants import InvariantError
    exp = Experiment(ExperimentConfig(train_iterations=1, comm_round=2,
                                      debug_checks=True), device="cpu")
    orig = exp.algo.round_inputs
    exp.algo.round_inputs = lambda t, r: (-orig(t, r)[0],) + orig(t, r)[1:]
    with pytest.raises(InvariantError, match="negative"):
        exp.run()


def _program_outputs(kind):
    x = torch.zeros(3, 4)
    if kind == "nan":
        x[1, 2] = float("nan")
    elif kind == "inf":
        x[0, 0] = float("inf")
    return dict(params=x, state={"mu": torch.ones(2)},
                rows=torch.zeros(5, dtype=torch.int32), absent=None)


@pytest.mark.parametrize("kind", ["finite", "inf", "nan"])
def test_check_no_nan_raises_on_nan_only(kind):
    """NaN only, as ``jax_debug_nans``: an inf alone passes; integer
    outputs and absent ones are skipped."""
    from feddrift_torch.utils.invariants import check_no_nan
    if kind != "nan":
        check_no_nan("K1 (local_sgd)", **_program_outputs(kind))
        return
    with pytest.raises(FloatingPointError,
                       match=r"the K1 \(local_sgd\) program: params$"):
        check_no_nan("K1 (local_sgd)", **_program_outputs(kind))


# ----------------------------------------------------------------------
# tests/test_invariants.py against both packages' copies
PACKAGES = ["feddrift_tpu", "feddrift_torch"]


def _invariants(pkg):
    import importlib
    return importlib.import_module(f"{pkg}.utils.invariants")


def _ok():
    M, C, T1, N = 2, 3, 4, 8
    return (np.ones((M, C, T1), np.float32), np.ones((M, C, N), np.float32),
            np.ones((M, 5), np.float32),
            dict(num_models=M, num_clients=C, num_steps_p1=T1, sample_num=N))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_check_round_inputs_accepts_valid(pkg):
    tw, sw, fm, kw = _ok()
    _invariants(pkg).check_round_inputs(tw, sw, fm, **kw)


MUTATIONS = [
    (lambda tw, sw, fm: (tw[:, :, :2], sw, fm), "time_w shape"),
    (lambda tw, sw, fm: (tw, sw[:1], fm), "sample_w shape"),
    (lambda tw, sw, fm: (tw, sw, fm[:1]), "feat_mask leading axis"),
    (lambda tw, sw, fm: (tw * np.nan, sw, fm), "non-finite"),
    (lambda tw, sw, fm: (tw - 2.0, sw, fm), "negative"),
    (lambda tw, sw, fm: (tw, sw - 2.0, fm), "sample_w has negative"),
    (lambda tw, sw, fm: (tw * 0.0, sw, fm), "all-zero"),
]


@pytest.mark.parametrize("mutation,match", MUTATIONS,
                         ids=[m[1].replace(" ", "_") for m in MUTATIONS])
def test_check_round_inputs_rejects_alike(mutation, match):
    tw, sw, fm, kw = _ok()
    msgs = {}
    for pkg in PACKAGES:
        inv = _invariants(pkg)
        with pytest.raises(inv.InvariantError, match=match) as got:
            inv.check_round_inputs(*mutation(tw, sw, fm), **kw)
        msgs[pkg] = str(got.value)
    assert msgs["feddrift_torch"] == msgs["feddrift_tpu"]


def test_weight_partition_alike():
    w = np.zeros((3, 2, 4), np.float32)
    w[1, 0, :] = 0.3
    w[1, 1, :] = 0.7
    msgs = {}
    for pkg in PACKAGES:
        inv = _invariants(pkg)
        inv.check_weight_partition(w, 1)
        with pytest.raises(inv.InvariantError) as got:
            inv.check_weight_partition(w, 0)
        msgs[pkg] = str(got.value)
    assert msgs["feddrift_torch"] == msgs["feddrift_tpu"]
