"""The port's safety planes against the JAX package's, on the CPU.

The divergence guard in the runner (ported from the reference's
``TestDivergenceInRunner``): poisoned per-round and fused losses roll the
pool back, skip the evals and end in ``DivergenceError``; a NaN pool
injected at step 1 does the same through the real losses, with an incident
bundle that ``python -m feddrift_torch incident`` renders; a healthy run is
the same with the guard on and off. Preemption (the reference's
``TestPreemptAutoResume``): SIGTERM after a step, then ``run
--auto_resume`` or ``resume --out_dir`` gives the uninterrupted run's
metrics bitwise. ``DivergenceGuard.check`` agrees with the reference's on
seeded loss sequences; ``obs.alerts.replay`` of one JAX CPU run's
``events.jsonl`` fires the same alerts in both packages; an incident
bundle of the port has the reference's file names for the sections
ported; the four planes are on by default in both packages.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.resilience.divergence import (DivergenceError,
                                                  DivergenceGuard)
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    base = dict(dataset="sine", model="fnn", concept_drift_algo="win-1",
                concept_num=2, client_num_in_total=4,
                client_num_per_round=4, train_iterations=2, comm_round=3,
                epochs=1, batch_size=16, sample_num=32,
                frequency_of_the_test=2, report_client=0,
                divergence_warmup_rounds=0)
    base.update(kw)
    return ExperimentConfig(**base)


def _leaf0(params):
    return params["Dense_0/kernel"].clone()


def _bits(t):
    return t.contiguous().view(torch.int32)


class TestDivergenceInRunner:
    def test_per_round_nan_rolls_back_then_aborts(self, monkeypatch):
        from feddrift_torch.core.step import TrainStep
        from feddrift_torch.simulation.runner import Experiment
        exp = Experiment(_cfg(chunk_rounds=False,
                              divergence_max_rollbacks=2), device="cpu")
        before = _leaf0(exp.pool.params)
        orig = TrainStep.train_round

        def poisoned(self, *a, **k):
            p, o, cp, n, losses, *rest = orig(self, *a, **k)
            return (p, o, cp, n, torch.full_like(losses, float("nan")),
                    *rest)

        monkeypatch.setattr(TrainStep, "train_round", poisoned)
        with pytest.raises(DivergenceError):
            exp.run()
        evs = exp.events.events("divergence_detected")
        assert len(evs) == 2 and evs[0]["reason"] == "nonfinite"
        assert evs[1]["consecutive"] == 2
        # both diverged rounds rolled back: params are still the initials
        assert torch.equal(_leaf0(exp.pool.params), before)
        assert exp.logger.series("Test/Acc") == []   # evals were skipped

    def test_fused_nan_restores_the_start_pool_and_skips_eval(
            self, monkeypatch):
        from feddrift_torch.core.step import TrainStep
        from feddrift_torch.simulation.runner import Experiment
        exp = Experiment(_cfg(chunk_rounds=True,
                              divergence_max_rollbacks=2), device="cpu")
        start = exp.pool.params
        before = {k: v.clone() for k, v in start.items()}
        orig = TrainStep.train_iteration_eval

        def poisoned(self, *a, **k):
            p, o, n, losses, bufs, total, *rest = orig(self, *a, **k)
            return (p, o, n, torch.full_like(losses, float("nan")), bufs,
                    total, *rest)

        monkeypatch.setattr(TrainStep, "train_iteration_eval", poisoned)
        with pytest.raises(DivergenceError):
            exp.run()
        assert len(exp.events.events("divergence_detected")) == 2
        # the rollback keeps the pool it started from: the same tensors,
        # never written by the fused step (no host copy is taken)
        assert exp.pool.params is start
        for k, v in before.items():
            assert torch.equal(exp.pool.params[k], v)
        assert exp.logger.series("Test/Acc") == []

    @pytest.mark.parametrize("chunk", [True, False], ids=["fused",
                                                          "per_round"])
    def test_healthy_run_is_untouched_by_the_guard(self, chunk):
        from feddrift_torch.simulation.runner import Experiment
        a = Experiment(_cfg(divergence_guard=True, chunk_rounds=chunk),
                       device="cpu")
        a.run()
        b = Experiment(_cfg(divergence_guard=False, chunk_rounds=chunk),
                       device="cpu")
        b.run()
        assert a.logger.series("Test/Acc") == b.logger.series("Test/Acc")
        for k, v in a.pool.params.items():
            assert torch.equal(_bits(v), _bits(b.pool.params[k]))
        assert not a.events.events("divergence_detected")

    @pytest.mark.parametrize("chunk", [True, False], ids=["fused",
                                                          "per_round"])
    def test_nan_pool_at_step_1_aborts_with_a_bundle(self, chunk, tmp_path):
        """A NaN in one model's Dense_0/kernel and an Inf in another's
        Dense_1/bias at step 1, through the real losses: every rollback is
        non-finite and restores the pool the diverged step (or round)
        started from bitwise, the run ends in DivergenceError after
        divergence_max_rollbacks, and the incident bundle names it."""
        from feddrift_torch.cli import main
        from feddrift_torch.simulation.runner import Experiment
        cfg = _cfg(chunk_rounds=chunk, train_iterations=6,
                   concept_drift_algo="softcluster",
                   concept_drift_algo_arg="H_A_C_1_10_0")
        exp = Experiment(cfg, out_dir=str(tmp_path), device="cpu")
        orig = exp.run_iteration

        def hooked(t):
            if t == 1:
                p = {k: v.clone() for k, v in exp.pool.params.items()}
                p["Dense_0/kernel"][0, 0, 1] = float("nan")
                p["Dense_1/bias"][1, 0] = float("inf")
                exp.pool.params = p
            return orig(t)

        exp.run_iteration = hooked
        inputs = []
        name = "train_iteration_eval" if chunk else "train_round"
        call = getattr(exp.step, name)

        def record(params, *a, **k):
            inputs.append({k2: v.clone() for k2, v in params.items()})
            return call(params, *a, **k)

        setattr(exp.step, name, record)
        with pytest.raises(DivergenceError):
            exp.run()
        evs = exp.events.events("divergence_detected")
        assert len(evs) == cfg.divergence_max_rollbacks
        assert {e["reason"] for e in evs} == {"nonfinite"}
        assert not torch.isfinite(inputs[-1]["Dense_0/kernel"]).all()
        for k, v in inputs[-1].items():
            assert torch.equal(_bits(exp.pool.params[k]), _bits(v))
        bundles = sorted(os.listdir(tmp_path / "incidents"))
        assert bundles[-1].endswith("exception_DivergenceError")
        meta = json.loads((tmp_path / "incidents" / bundles[-1]
                           / "meta.json").read_text())
        assert meta["reason"] == "exception:DivergenceError"
        assert main(["incident", str(tmp_path)]) == 0

    def test_rendered_bundle_names_the_divergence(self, tmp_path, capsys):
        from feddrift_torch.cli import main
        from feddrift_torch.obs import incident
        mgr = incident.IncidentManager(str(tmp_path), debounce_s=0)
        mgr.on_exception(DivergenceError("3 consecutive diverged rounds"))
        assert main(["incident", str(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "exception:DivergenceError" in out
        assert "consecutive diverged rounds" in out


def _guard_sequence(seed):
    rng = np.random.default_rng(seed)
    steps = []
    for t in range(6):
        rounds = []
        for r in range(12):
            losses = rng.uniform(0.2, 1.0, (3, 4))
            n = (rng.random((3, 4)) < 0.8).astype(np.float32) * 50
            kind = rng.random()
            if kind < 0.08:
                losses[rng.integers(3), rng.integers(4)] = np.nan
            elif kind < 0.12:
                losses[rng.integers(3), rng.integers(4)] = np.inf
            elif kind < 0.25:
                losses *= rng.uniform(5, 40)
            rounds.append((losses.astype(np.float32), n))
        steps.append(rounds)
    return steps


@pytest.mark.parametrize("seed,warmup,factor", [(0, 0, 10.0), (1, 5, 10.0),
                                                (2, 3, 4.0), (3, 1, 2.0)])
def test_guard_agrees_with_the_reference(seed, warmup, factor):
    from feddrift_tpu.resilience.divergence import DivergenceError as JErr
    from feddrift_tpu.resilience.divergence import DivergenceGuard as JGuard
    ours = DivergenceGuard(spike_factor=factor, max_rollbacks=4,
                           warmup=warmup)
    ref = JGuard(spike_factor=factor, max_rollbacks=4, warmup=warmup)
    fired = 0
    for rounds in _guard_sequence(seed):
        ours.new_window()
        ref.new_window()
        for losses, n in rounds:
            a, b = ours.check(losses, n), ref.check(losses, n)
            assert a[:2] == b[:2]
            assert a[2] == b[2] or (np.isnan(a[2]) and np.isnan(b[2]))
            assert (ours.baseline, ours.healthy_rounds) \
                == (ref.baseline, ref.healthy_rounds)
            if a[0]:
                fired += 1
                raised = []
                for g, err in ((ours, DivergenceError), (ref, JErr)):
                    try:
                        g.record_rollback()
                        raised.append(False)
                    except err:
                        raised.append(True)
                assert raised[0] == raised[1]
                if raised[0]:
                    return
    assert fired > 0


def test_alert_replay_matches_the_reference(tmp_path):
    """One small JAX CPU run's events.jsonl, replayed through both
    packages' rules, fires the same alerts."""
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.obs import alerts as jalerts
    from feddrift_tpu.simulation.runner import Experiment as JExp

    from feddrift_torch.obs import alerts
    kw = dict(client_num_in_total=10, client_num_per_round=10,
              train_iterations=4, comm_round=3, sample_num=50,
              batch_size=25, epochs=1, alerts=False,
              incident_capture=False)
    JExp(JCfg(**kw), out_dir=str(tmp_path)).run()
    with open(tmp_path / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    # and a churn storm the rules must catch
    events += [{"kind": k, "iteration": 4} for k in
               ("cluster_create", "cluster_merge", "cluster_delete",
                "cluster_split", "cluster_create")]
    events += [{"kind": "cluster_state", "iteration": 4}]
    strip = lambda a: {k: v for k, v in a.items() if k != "_ts"}
    got = [strip(a) for a in alerts.replay(events)]
    want = [strip(a) for a in jalerts.replay(events)]
    assert got == want
    assert {a["rule"] for a in got} >= {"ari_collapse", "cluster_churn"}


def test_incident_bundle_has_the_reference_file_names(tmp_path):
    from feddrift_tpu.obs import blackbox as jbox
    from feddrift_tpu.obs import events as jevents
    from feddrift_tpu.obs import incident as jincident

    from feddrift_torch.obs import blackbox, incident
    from feddrift_torch.obs import events as tevents
    names = {}
    for tag, ev, box, inc in (("ref", jevents, jbox, jincident),
                              ("port", tevents, blackbox, incident)):
        run = tmp_path / tag
        (run / "ckpt").mkdir(parents=True)
        (run / "ckpt" / "MANIFEST.json").write_text(
            json.dumps({"iteration": 1, "global_round": 6}))
        (run / "alerts.jsonl").write_text(
            json.dumps({"kind": "alert_raised", "rule": "x"}) + "\n")
        bus = ev.configure(None)
        rec = box.FlightRecorder().attach(bus)
        mgr = inc.IncidentManager(str(run), recorder=rec,
                                  config_json="{}",
                                  ckpt_path=str(run / "ckpt")).attach(bus)
        bus.emit("alert_raised", rule="ari_collapse", severity="crit",
                 message="m")
        assert len(mgr.captured) == 1
        names[tag] = set(os.listdir(mgr.captured[0]))
        mgr.detach()
    # since the port has the host-plane observatory, its bundles carry
    # host_ledger.json (and hostprof.folded with a sampler armed) too
    assert names["port"] == names["ref"]
    assert {"meta.json", "flight.json", "trace.json", "alerts_tail.jsonl",
            "host_ledger.json", "config.json",
            "MANIFEST.json"} <= names["port"]


def test_planes_are_on_by_default_as_in_the_reference():
    from feddrift_tpu.config import ExperimentConfig as JCfg
    fields = ("preempt_signals", "divergence_guard",
              "divergence_spike_factor", "divergence_max_rollbacks",
              "divergence_warmup_rounds", "alerts", "alert_window",
              "alert_churn_threshold", "incident_capture", "incident_ring",
              "incident_debounce_s", "incident_max_bundles",
              "obs_max_file_mb")
    ours, ref = ExperimentConfig(), JCfg()
    assert {f: getattr(ours, f) for f in fields} \
        == {f: getattr(ref, f) for f in fields}
    for bad in (dict(divergence_spike_factor=1.0),
                dict(divergence_max_rollbacks=0), dict(alert_window=0),
                dict(incident_ring=4), dict(obs_max_file_mb=-1)):
        with pytest.raises(ValueError):
            ExperimentConfig(**bad)


class TestPreemptAutoResume:
    """SIGTERM mid-run -> checkpoint at the iteration boundary -> the run
    continued by ``run --auto_resume`` (or ``resume --out_dir``) is the
    uninterrupted run, bitwise."""

    _CLI_ARGS = ["--platform", "cpu", "--dataset", "sine", "--model", "fnn",
                 "--concept_drift_algo", "win-1", "--concept_num", "2",
                 "--client_num_in_total", "4", "--client_num_per_round", "4",
                 "--train_iterations", "3", "--comm_round", "3",
                 "--epochs", "1", "--batch_size", "16", "--sample_num", "32",
                 "--frequency_of_the_test", "2", "--report_client", "0"]

    def _cfg(self):
        return ExperimentConfig(
            dataset="sine", model="fnn", concept_drift_algo="win-1",
            concept_num=2, client_num_in_total=4, client_num_per_round=4,
            train_iterations=3, comm_round=3, epochs=1, batch_size=16,
            sample_num=32, frequency_of_the_test=2, report_client=0)

    def _interrupted(self, out):
        from feddrift_torch.simulation.runner import Experiment
        part = Experiment(self._cfg(), out_dir=out, device="cpu")
        orig = part.run_iteration

        def hooked(t):
            orig(t)
            if t == 1:
                os.kill(os.getpid(), signal.SIGTERM)

        part.run_iteration = hooked
        part.run()
        assert part.preempted
        kinds = [e["kind"] for e in part.events.events()]
        assert "preempt_checkpoint" in kinds and "run_end" in kinds
        assert part.events.events("run_end")[0]["preempted"] is True

    @pytest.mark.parametrize("how", ["auto_resume", "resume"])
    def test_sigterm_then_resume_matches_uninterrupted(self, tmp_path,
                                                       capsys, how):
        from feddrift_torch.cli import main
        from feddrift_torch.simulation.runner import Experiment
        full = Experiment(self._cfg(), device="cpu")
        full.run()
        full_accs = dict(full.logger.series("Test/Acc"))
        out = str(tmp_path / "run")
        self._interrupted(out)
        capsys.readouterr()
        argv = (["run", *self._CLI_ARGS, "--flat_out_dir", "--out_dir", out,
                 "--auto_resume"] if how == "auto_resume"
                else ["resume", "--out_dir", out, "--platform", "cpu"])
        assert main(argv) == 0
        final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert final["preempted"] is False
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        seen = [(r["iteration"], r["round"]) for r in rows]
        assert len(seen) == len(set(seen)), "duplicate (iteration, round)"
        assert {r["round"]: r["Test/Acc"] for r in rows} == full_accs
        assert final["Test/Acc"] == full.logger.last("Test/Acc")

    def test_auto_resume_on_fresh_dir_is_plain_run(self, tmp_path, capsys):
        from feddrift_torch.cli import main
        out = str(tmp_path / "fresh")
        assert main(["run", *self._CLI_ARGS, "--flat_out_dir",
                     "--out_dir", out, "--auto_resume"]) == 0
        final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert final["rounds"] == 9 and final["preempted"] is False
