"""Client sampling and the per-round path of the port, on the CPU.

- The masks: ``Experiment._client_masks`` against the reference's for
  several (C, k) and rounds, exactly (both use ``RandomState(r).choice``).
- Fused against per-round: a chunkable algorithm gives bitwise-equal
  Test/Acc series and final pool params on the two paths, with and without
  sampling, and sampling changes the trajectory (as the reference's
  ``tests/test_e2e.py`` requires of it). Unsampled clients report n = 0.
- Against the reference end to end: at SEA's defaults every batch of step
  0 is the whole of step 0 (N = B = 500, one slot, one step of weight), so
  both packages train on the same batches there and the same sampled
  clients; step 0's evals agree to float32 rounding (atol 1e-4 on
  accuracies, 1e-3 on losses), as in ``test_torch_runner.py``.
- The per-round algorithms (CFL, IFCA with re-clustering) run end to end,
  through the CLI, and resume bitwise.
"""

import json
import types

import jax
import numpy as np
import pytest
import torch

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.convert import params_from_jax
from feddrift_torch.simulation.runner import Experiment
from torch_threads import one_intra_op_thread  # noqa: F401

SMALL = dict(client_num_in_total=6, train_iterations=2, comm_round=13,
             frequency_of_the_test=5, sample_num=50)


def _run(**kw):
    exp = Experiment(ExperimentConfig(**kw), device="cpu")
    exp.run()
    return exp


def _series(exp):
    return [(r["round"], r["Test/Acc"]) for r in exp.logger.history]


@pytest.mark.parametrize("C,k,rounds", [
    (6, 4, range(13)), (10, 4, range(200)), (10, 1, [0, 7, 199]),
    (10, 9, range(50)), (6, 6, range(5)), (10, 10, range(3))])
def test_masks_equal_the_reference(C, k, rounds):
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.simulation.runner import Experiment as JExp
    kw = dict(client_num_in_total=C, client_num_per_round=k)
    jself = types.SimpleNamespace(
        cfg=JCfg(**kw), population_mode=False, C_=C, C_pad=C,
        fault_injector=None, failure_detector=None)
    want = JExp._client_masks(jself, 3, rounds)
    got = Experiment._client_masks(
        types.SimpleNamespace(cfg=ExperimentConfig(**kw), C_=C), rounds)
    if k == C:
        assert got is None and want is None
        return
    assert got.dtype == np.float32 and got.shape == (len(rounds), C)
    assert np.array_equal(got, want)
    assert (got.sum(1) == k).all()


@pytest.mark.parametrize("algo,arg,k", [
    ("softcluster", "H_A_C_1_10_0", 4), ("softcluster", "H_A_C_1_10_0", 6),
    ("softcluster", "mmacc_06", 3), ("win-1", "", 4), ("exp", "", 6)])
def test_fused_and_per_round_paths_agree(algo, arg, k):
    kw = dict(SMALL, concept_drift_algo=algo, concept_drift_algo_arg=arg,
              client_num_per_round=k)
    fused = _run(**kw)
    per_round = _run(**kw, chunk_rounds=False)
    assert _series(fused) == _series(per_round)
    assert [r for r, _ in _series(fused)] == [0, 5, 10, 12, 13, 18, 23, 25]
    for key, v in fused.pool.params.items():
        assert torch.equal(v, per_round.pool.params[key]), key


def test_sampling_changes_the_trajectory():
    a = _run(**SMALL, client_num_per_round=4)
    b = _run(**SMALL, client_num_per_round=6)
    assert _series(a) != _series(b)


def test_unsampled_clients_report_no_samples():
    """On both paths, each round's n is 0 for the clients its mask leaves
    out, and positive for a sampled client's model."""
    for chunk in (False, True):
        exp = Experiment(ExperimentConfig(**SMALL, client_num_per_round=2,
                                          chunk_rounds=chunk), device="cpu")
        seen = []
        after = exp.algo.after_round

        def record(t, r, prev, agg, client, n, after=after, seen=seen):
            seen.append((r, n.clone()))
            return after(t, r, prev, agg, client, n)
        exp.algo.after_round = record
        exp.run()
        masks = exp._client_masks(range(SMALL["comm_round"]))
        assert len(seen) == (2 if chunk else 2 * SMALL["comm_round"])
        for r, n in seen:
            out = masks[r] == 0
            assert (n[:, out] == 0).all() and (n[0, ~out] > 0).all()


def test_iteration_end_counts_the_sampled_clients(tmp_path):
    exp = Experiment(ExperimentConfig(**SMALL, client_num_per_round=4),
                     out_dir=str(tmp_path), device="cpu")
    exp.run()
    ends = [json.loads(line) for line in
            (tmp_path / "events.jsonl").read_text().splitlines()
            if json.loads(line)["kind"] == "iteration_end"]
    assert [e["examples"] for e in ends] == [13 * 5 * 50 * 4] * 2


@pytest.mark.parametrize("algo,arg,k,chunk", [
    ("softcluster", "H_A_C_1_10_0", 4, True),
    ("softcluster", "H_A_C_1_10_0", 4, False),
    ("softcluster", "cfl_0.1_win-1", 10, True),
    ("oblivious", "", 10, True)])
def test_step_0_tracks_the_reference(algo, arg, k, chunk):
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.simulation.runner import Experiment as JExp
    kw = dict(train_iterations=1, comm_round=12, frequency_of_the_test=4,
              concept_drift_algo=algo, concept_drift_algo_arg=arg,
              client_num_per_round=k, chunk_rounds=chunk)
    jexp = JExp(JCfg(**kw))
    init = jax.tree_util.tree_map(np.asarray, jexp.pool.params)
    jexp.run()
    exp = Experiment(ExperimentConfig(**kw), device="cpu")
    exp.pool.params = params_from_jax(init, "cpu")
    exp.run()
    ours, ref = exp.logger.history, jexp.logger.history
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert (a["iteration"], a["round"]) == (b["iteration"], b["round"])
        for key in a:
            if "Acc" in key:
                assert a[key] == pytest.approx(b[key], abs=1e-4), key
            elif "Loss" in key:
                assert a[key] == pytest.approx(b[key], abs=1e-3), key


@pytest.mark.parametrize("arg", ["cfl_0.1_win-1", "hard-r"])
def test_per_round_algorithm_resumes_bitwise(tmp_path, arg):
    cfg = ExperimentConfig(train_iterations=3, comm_round=8,
                           frequency_of_the_test=4, sample_num=60,
                           batch_size=20, concept_drift_algo_arg=arg, seed=2)
    full = Experiment(cfg, out_dir=str(tmp_path / "full"), device="cpu")
    full.run()
    cut = Experiment(cfg, out_dir=str(tmp_path / "cut"), device="cpu")
    with cut.logger, cut.events:
        cut.run_iteration(0)
        cut.run_iteration(1)
    again = Experiment.resume(cfg, str(tmp_path / "cut"), device="cpu")
    again.run()
    rows = [json.loads(line) for line in
            (tmp_path / "cut" / "metrics.jsonl").read_text().splitlines()]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "_ts"}
                        for r in rs]
    assert strip(rows) == strip(full.logger.history)
    # the per-round path waits for the device every profile_rounds-th
    # global round (10: round 20 of step 2's 16..23), as the reference does
    bd = full.last_round_breakdown
    assert 0.0 <= bd["host_overhead_frac"] <= 1.0
    assert bd["profiled_rounds"] == 1
    assert {"dispatch", "device_compute", "writeback", "eval"} <= set(
        bd["segments"])
