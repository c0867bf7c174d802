"""Whole runs of the conv models on the CPU: the three committed conv runs'
configurations (``scripts/run_round5_cpu.sh``) cut to seconds, the fused
path bitwise the per-round path, and ``resume`` bitwise the continuous run.

The committed command lines are read from the script and parsed by the
CLI's own ``run`` flags, so every flag of them must be accepted; then
the cuts are appended (argparse keeps a flag's last value): two steps of
one round, 64 rows a step (32 for resnet8's), femnist's 20 clients
cut to 4 with 2 a round, fmow's images to 8 x 8 (its cnn at 32 x 32 is 40
pairs of 2.2 M params, ~20 s a round on a CPU). The card runs them whole
(``chip_smoke.py``'s ``train_conv``).
"""

import argparse
import json
import os
import re

import numpy as np
import pytest
import torch

from feddrift_torch.cli import _add_run_args, _cfg_from_args, run_dir
from feddrift_torch.config import ExperimentConfig
from feddrift_torch.simulation.runner import Experiment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "run_round5_cpu.sh")
# committed run: (the cuts, the path its steps take)
COMMITTED = {
    "femnist-smooth-cnn-ada-win-1_iter-s0": (
        ["--train_iterations", "2", "--comm_round", "1", "--sample_num", "64",
         "--client_num_in_total", "4", "--client_num_per_round", "2"],
        "per_round"),
    "fmow-smooth-cnn-softcluster-H_A_C_1_10_0-s0": (
        ["--train_iterations", "2", "--comm_round", "1", "--sample_num", "64",
         "--fmow_image_size", "8"], "per_round"),
    "cifar10-smooth-resnet8-hard-r-s0": (
        ["--train_iterations", "2", "--comm_round", "1",
         "--sample_num", "32"], "per_round")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def committed_args(name: str) -> list[str]:
    """The ``run`` flags of a committed run in the script that made it."""
    text = open(SCRIPT).read().replace("\\\n", " ")
    line = re.search(rf"^run {re.escape(name)} (.*)$", text, re.M).group(1)
    return line.split()


def _parse(args):
    parser = argparse.ArgumentParser()
    _add_run_args(parser)
    return parser.parse_args(args)


def _paths(exp):
    paths = []
    for name in ("_run_iteration_fused", "_run_rounds"):
        fn = getattr(exp, name)

        def inner(t, opt, fn=fn, name=name):
            paths.append("fused" if name == "_run_iteration_fused"
                         else "per_round")
            return fn(t, opt)
        setattr(exp, name, inner)
    return paths


@pytest.mark.parametrize("name", sorted(COMMITTED))
def test_committed_configuration_runs_cut(name, tmp_path):
    cuts, path = COMMITTED[name]
    args = _parse(committed_args(name) + ["--flat_out_dir", "--platform",
                                          "cpu", "--out_dir",
                                          str(tmp_path)] + cuts)
    cfg = _cfg_from_args(args)
    assert run_dir(cfg, args.flat_out_dir) == str(tmp_path)
    dataset, model = name.split("-")[0] + "-smooth", name.split("-")[2]
    assert (cfg.dataset, cfg.model, cfg.batch_size, cfg.epochs) == (
        dataset, model, 32, 5)
    exp = Experiment(cfg, out_dir=str(tmp_path), device="cpu")
    paths = _paths(exp)
    exp.run()
    assert paths == [path] * cfg.train_iterations
    accs = [r["Test/Acc"] for r in exp.logger.history]
    evals = len(exp.step.eval_rounds(cfg.comm_round,
                                     cfg.frequency_of_the_test))
    assert len(accs) == cfg.train_iterations * evals
    assert all(0.0 <= a <= 1.0 for a in accs)
    assert all(np.isfinite(r["Test/Loss"]) for r in exp.logger.history)
    assert all(torch.isfinite(p).all() for p in exp.pool.params.values())
    assert (tmp_path / "ckpt" / "MANIFEST.json").is_file()


# chunkable runs small enough for seconds: the cnn under win-1 (M 1) with
# client sampling, resnet8 under softcluster (M 2)
SMALL = dict(train_iterations=2, comm_round=2, frequency_of_the_test=2,
             sample_num=32, batch_size=16, epochs=1, client_num_in_total=3,
             concept_num=2, change_points="rand")
RUNS = {"cnn": dict(dataset="femnist-smooth", model="cnn",
                    concept_drift_algo="win-1", client_num_per_round=2),
        "resnet8": dict(dataset="cifar10-smooth", model="resnet8", lr=0.05,
                        client_num_per_round=3)}


def _rows(history):
    return [{k: v for k, v in r.items() if k != "_ts"} for r in history]


@pytest.mark.parametrize("model", sorted(RUNS))
def test_fused_path_is_bitwise_the_per_round_path(model):
    runs = {}
    for chunk in (True, False):
        exp = Experiment(ExperimentConfig(**SMALL, **RUNS[model],
                                          chunk_rounds=chunk), device="cpu")
        paths = _paths(exp)
        exp.run()
        assert set(paths) == {"fused" if chunk else "per_round"}
        runs[chunk] = exp
    assert _rows(runs[True].logger.history) == \
        _rows(runs[False].logger.history)
    for k, p in runs[True].pool.params.items():
        assert torch.equal(p, runs[False].pool.params[k]), k


def test_resume_of_a_conv_run_is_bitwise(tmp_path):
    cfg = ExperimentConfig(**SMALL, **RUNS["cnn"], seed=2)
    full = Experiment(cfg, out_dir=str(tmp_path / "full"), device="cpu")
    full.run()
    cut = Experiment(cfg, out_dir=str(tmp_path / "cut"), device="cpu")
    with cut.logger, cut.events:
        cut.run_iteration(0)
    again = Experiment.resume(cfg, str(tmp_path / "cut"), device="cpu")
    assert again.start_iteration == 1
    again.run()
    read = [json.loads(line) for line in
            (tmp_path / "cut" / "metrics.jsonl").read_text().splitlines()]
    assert _rows(read) == _rows(full.logger.history)
    for k, p in again.pool.params.items():
        assert torch.equal(p, full.pool.params[k]), k


def test_pool_of_a_conv_model():
    """``ModelPool`` with a conv module: a pool's slots, ``apply`` (one
    model on a batch, one forward) and ``apply_rows`` (per-row params, each
    row a batch of one, as the reference's ``ForwardStep`` applies it), and
    the slot edits the algorithms make."""
    from feddrift_torch.core.pool import ModelPool
    from feddrift_torch.models.resnet import ResNetCifar
    mod = ResNetCifar((8, 8, 3), 5, depth=8)
    x = torch.rand(4, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    pool = ModelPool.create(mod, x[:2], 3, seed=1, identical=False,
                            device="cpu")
    assert pool.example_input.shape == (2, 8, 8, 3)
    one = pool.slot(1)
    assert torch.equal(pool.apply(one, x), mod(one, x))
    rows = {k: p[torch.tensor([0, 2, 2, 1])] for k, p in pool.params.items()}
    got = pool.apply_rows(rows, x)
    for i, m in enumerate((0, 2, 2, 1)):
        torch.testing.assert_close(got[i], mod(pool.slot(m), x[i:i + 1])[0],
                                   rtol=1e-6, atol=1e-6)
    before = {k: p.clone() for k, p in pool.params.items()}
    pool.merge_slots(0, 1, 0.25, 0.75)
    for k, p in pool.params.items():
        torch.testing.assert_close(p[0], 0.25 * before[k][0]
                                   + 0.75 * before[k][1])
        assert torch.equal(p[1], pool.init_params[k])
    pool.copy_slot(2, 0)
    assert all(torch.equal(p[2], p[0]) for p in pool.params.values())


def test_debug_checks_name_the_conv_program():
    """``debug_checks`` on a conv round: a NaN in a model's conv kernel
    raises ``FloatingPointError`` naming the model-generic local SGD."""
    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.models.cnn import CNNFedAvg
    mod = CNNFedAvg((8, 8, 3), 5)
    step = TrainStep(mod, 4, 1, 5, device="cpu", debug_nans=True)
    params = {k: v[None].expand(2, *v.shape).clone() for k, v in
              mod.init_params(torch.Generator().manual_seed(0),
                              "cpu").items()}
    params["Conv_0/kernel"][0, 0, 0, 0, 0] = float("nan")
    x = torch.rand(2, 2, 4, 8, 8, 3)
    y = torch.zeros(2, 2, 4, dtype=torch.int32)
    with pytest.raises(FloatingPointError, match="model_local_sgd"):
        step.train_round(params, step.init_opt_states(params, 2, 2), x, y,
                         torch.ones(2, 2, 2))


def test_smoke_drives_the_committed_configurations():
    """``chip_smoke.CONV_RUNS`` is each committed command line as the CLI
    parses it (femnist's 5 steps cut to the 2 its committed file holds),
    pinned to the committed file's final Test/Acc, and gated."""
    import chip_smoke
    for run, kw, pinned, _ in chip_smoke.CONV_RUNS:
        cfg = _cfg_from_args(_parse(committed_args(run)))
        want = {k: getattr(cfg, k) for k in kw}
        if run.startswith("femnist"):
            assert want["train_iterations"] == 5
            want["train_iterations"] = 2
        assert kw == want, run
        final = {}
        for line in open(os.path.join(REPO, "runs", run, "metrics.jsonl")):
            rec = json.loads(line)
            final[rec["iteration"]] = rec["Test/Acc"]
        assert tuple(final[t] for t in sorted(final)) == pinned
        assert len(pinned) == kw["train_iterations"]
        step, mean = chip_smoke._conv_gate(run)
        assert step >= chip_smoke.STEP_ACC_TOL
        assert mean >= chip_smoke.MEAN_ACC_TOL
