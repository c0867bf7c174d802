"""The port's training run end to end on the CPU: against the JAX package,
against itself (same seed, resume), through checkpoints and the CLI.

Against the reference: both packages run SEA / fnn / softcluster
``H_A_C_1_10_0`` at T = 3, R = 20, eval every 5 rounds, seed 0, the port
starting from the reference's initial pool (carried across with
``params_from_jax``; torch's generator would draw another init). Step 0
then trains on the same batches in both (every client on step 0 alone,
nb = 1), so its evals agree to float32 rounding (atol 1e-4 on accuracies,
1e-3 on the losses). Steps 1 and 2 draw their batches from different
generators, so their final Test/Acc agree within 0.03: 1.25 x the largest
spread of that number across seeds 0-2 of either package at this size
(0.024 for the port, 0.023 for the reference; each package's own runs).
The CLI's tests are in ``test_torch_cli.py``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from feddrift_torch import obs
from feddrift_torch.config import ExperimentConfig
from feddrift_torch.convert import params_from_jax
from feddrift_torch.simulation.runner import Experiment
from feddrift_torch.utils import checkpoint
from torch_threads import one_intra_op_thread  # noqa: F401

SMALL = dict(train_iterations=3, comm_round=20, frequency_of_the_test=5)
LATER_STEP_TOL = 0.03


def _finals(history):
    out = {}
    for r in history:
        out[r["iteration"]] = r["Test/Acc"]
    return [out[t] for t in sorted(out)]


def _rows(history):
    return [{k: v for k, v in r.items() if k != "_ts"} for r in history]


def test_small_run_tracks_the_reference():
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.simulation.runner import Experiment as JExp
    jexp = JExp(JCfg(**SMALL))
    init = jax.tree_util.tree_map(np.asarray, jexp.pool.params)
    jexp.run()
    exp = Experiment(ExperimentConfig(**SMALL), device="cpu")
    exp.pool.params = params_from_jax(init, "cpu")
    exp.run()
    ours, ref = exp.logger.history, jexp.logger.history
    assert len(ours) == len(ref) == 3 * 5
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        assert (a["iteration"], a["round"]) == (b["iteration"], b["round"])
    for a, b in zip(ours[:5], ref[:5]):           # step 0: the same batches
        for k in a:
            if "Acc" in k:
                assert a[k] == pytest.approx(b[k], abs=1e-4), k
            elif "Loss" in k:
                assert a[k] == pytest.approx(b[k], abs=1e-3), k
            elif k != "_ts":
                assert a[k] == b[k], k
    for a, b in zip(_finals(ours)[1:], _finals(ref)[1:]):
        assert abs(a - b) <= LATER_STEP_TOL
    assert exp.logger.summary["num_models"] == jexp.logger.summary["num_models"]


def test_fresh_evaluate_repeats_the_final_eval():
    """``evaluate`` recomputes both eval matrices of the final params; the
    fused loop's last eval slot holds the same numbers."""
    exp = Experiment(ExperimentConfig(**SMALL, seed=2), device="cpu")
    exp.run()
    last = dict(exp.logger.history[-1])
    again = exp.evaluate(2, 19)
    assert again["round"] == 60                   # logged at the run's end
    for k in last:
        if k not in ("_ts", "round"):
            assert again[k] == pytest.approx(last[k], abs=1e-6), k


def test_same_seed_same_metrics():
    a = Experiment(ExperimentConfig(**SMALL, seed=3), device="cpu")
    a.run()
    b = Experiment(ExperimentConfig(**SMALL, seed=3), device="cpu")
    b.run()
    assert _rows(a.logger.history) == _rows(b.logger.history)
    c = Experiment(ExperimentConfig(**SMALL, seed=4), device="cpu")
    c.run()
    assert _rows(c.logger.history) != _rows(a.logger.history)


def test_resume_equals_the_continuous_run(tmp_path):
    cfg = ExperimentConfig(**SMALL, seed=1)
    full = Experiment(cfg, out_dir=str(tmp_path / "full"), device="cpu")
    full.run()
    cut = Experiment(cfg, out_dir=str(tmp_path / "cut"), device="cpu")
    with cut.logger, cut.events:
        cut.run_iteration(0)
        cut.run_iteration(1)
    manifest = json.loads((tmp_path / "cut" / "ckpt" / "MANIFEST.json")
                          .read_text())
    assert manifest["iteration"] == 1 and manifest["global_round"] == 40
    assert manifest["config"]["seed"] == 1
    again = Experiment.resume(cfg, str(tmp_path / "cut"), device="cpu")
    assert again.start_iteration == 2 and again.global_round == 40
    again.run()
    read = [json.loads(line) for line in
            (tmp_path / "cut" / "metrics.jsonl").read_text().splitlines()]
    assert _rows(read) == _rows(full.logger.history)


def test_corrupt_checkpoint_falls_back_to_the_old_generation(tmp_path):
    cfg = ExperimentConfig(**SMALL)
    exp = Experiment(cfg, out_dir=str(tmp_path), device="cpu")
    exp.run()
    with open(tmp_path / "ckpt" / "pool.pt", "r+b") as f:
        f.seek(40)
        f.write(b"\x00garbage")
    bus = obs.configure(None)
    state = checkpoint.load_checkpoint(str(tmp_path / "ckpt"), "cpu")
    assert state["iteration"] == 1                  # the .old generation
    assert [e["path"] for e in bus.events("checkpoint_corrupt")] == [
        str(tmp_path / "ckpt")]
    (tmp_path / "ckpt.old" / "MANIFEST.json").write_text("{")
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.load_checkpoint(str(tmp_path / "ckpt"), "cpu")
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(str(tmp_path / "none"), "cpu")


def test_run_emits_iteration_events(tmp_path):
    exp = Experiment(ExperimentConfig(**SMALL), out_dir=str(tmp_path),
                     device="cpu")
    exp.run()
    kinds = [json.loads(line)["kind"] for line in
             (tmp_path / "events.jsonl").read_text().splitlines()]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("iteration_end") == 3
    assert kinds.count("checkpoint_save") == 3
    bd = exp.last_round_breakdown
    assert bd["rounds"] == 20 and {"device_compute", "eval", "drift_decision",
                                   "dispatch_gap"} <= set(bd["segments"])


def test_entry_points_refuse_the_cpu_unasked(monkeypatch):
    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.models.mlp import FeedForwardNN
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(ExperimentConfig(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainStep(FeedForwardNN((3,), 2), 500, 5, 2)
