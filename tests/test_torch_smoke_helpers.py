"""The pure helpers of ``chip_smoke.py`` on the CPU: the reference run it
holds the training against, K1's bound from the round's own draws, and the
per-row Dense's bound over the routes the card offers."""

import json
import os
import shutil

import pytest
import torch

import chip_smoke
from torch_threads import one_intra_op_thread  # noqa: F401


def test_reference_run_is_the_committed_one():
    assert chip_smoke._reference_accs() == list(chip_smoke.REF_ACCS)


@pytest.mark.parametrize("run", chip_smoke.ALGO_RUNS, ids=lambda r: r[3])
def test_algorithm_reference_runs_are_the_committed_ones(run):
    """train_algos' committed SEA runs: R = 200, T = 10, one run a file."""
    algo, arg, path, name, pinned = run
    metrics = os.path.join(os.path.dirname(chip_smoke.REF_RUN), "..", name,
                           "metrics.jsonl")
    assert chip_smoke._reference_accs(metrics, pinned) == list(pinned)
    rows = [json.loads(ln) for ln in open(metrics)]
    assert rows[-1]["round"] == 1999 and rows[-1]["iteration"] == 9
    assert name == f"sea-fnn-{algo}-{arg}-s0"
    per_round = "cfl" in arg or algo in ("ada", "clusterfl", "aue", "auepc",
                                         "kue")
    assert path == ("per_round" if per_round else "fused")


def test_committed_cfl_run_makes_the_pinned_first_split():
    """The committed CFL run ends step 0 with the clients on the models
    that ``CFL_FIRST_SPLIT`` and ``CFL_ASSIGNMENT`` pin, and later puts
    other clients elsewhere than ``CFL_ASSIGNMENT`` does (section 6 of
    PERF.md says why the card is held to step 0 only)."""
    name = chip_smoke.ALGO_RUNS[0][3]
    assert "cfl" in name
    got = chip_smoke._reference_assignment(os.path.join(
        os.path.dirname(chip_smoke.REF_RUN), "..", name, "metrics.jsonl"))
    _, model, new_model, kept, moved = chip_smoke.CFL_FIRST_SPLIT
    assert got[0] == list(chip_smoke.CFL_ASSIGNMENT[0])
    assert [c for c, m in enumerate(got[0]) if m == model] == kept
    assert [c for c, m in enumerate(got[0]) if m == new_model] == moved
    assert len(got) == len(chip_smoke.CFL_ASSIGNMENT)
    assert got[1:] != [list(a) for a in chip_smoke.CFL_ASSIGNMENT[1:]]


@pytest.mark.parametrize("how", ["appended", "altered"])
def test_reference_refuses_another_file(tmp_path, monkeypatch, how):
    path = tmp_path / "metrics.jsonl"
    shutil.copy(chip_smoke.REF_RUN, path)
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    if how == "appended":       # a second run written into the same file
        extra = [dict(r, **{"Test/Acc": 0.5}) for r in rows]
    else:                       # one value off
        rows[-1]["Test/Acc"] += 1e-4
        extra = []
    path.write_text("".join(json.dumps(r) + "\n" for r in rows + extra))
    monkeypatch.setattr(chip_smoke, "REF_RUN", str(path))
    with pytest.raises(AssertionError, match="not the committed reference"):
        chip_smoke._reference_accs()


DIMS = dict(M=2, C=3, S=4, B=500, F=3, H=10, K=2)


def _bound(t_idx, total_w, N=500):
    """The bound of contiguous batches: slot 0 of step ``t_idx``."""
    rows = (t_idx.long() * N)[..., None] + torch.arange(DIMS["B"])
    return chip_smoke._local_sgd_bound_ms(
        rows, total_w, **DIMS, index_bytes=2 * 4 * t_idx.numel())


def test_local_sgd_bound_reads_each_batch_once():
    M, C, S = DIMS["M"], DIMS["C"], DIMS["S"]
    total_w = torch.ones(M, C)
    same = torch.zeros(M, C, S, dtype=torch.int32)       # C distinct batches
    apart = torch.arange(M * C * S, dtype=torch.int32).view(M, C, S) % 7
    lo, lo_by = _bound(same, total_w)
    hi, _ = _bound(apart, total_w)
    # the pairs' work is the same, so only the batch bytes differ
    assert lo_by == "operations" and hi >= lo
    P = 3 * 10 + 10 + 10 * 2 + 2
    flops = M * C * S * (500 * (4 * 3 * 10 + 6 * 10 * 2 + 6 * 2 + 2 * 10)
                         + 14 * P)
    assert lo == pytest.approx(flops / chip_smoke.F32_FLOPS_PER_S * 1e3)


def test_local_sgd_bound_counts_active_pairs_only():
    M, C, S = DIMS["M"], DIMS["C"], DIMS["S"]
    t_idx = torch.arange(M * C * S, dtype=torch.int32).view(M, C, S)
    total_w = torch.ones(M, C)
    full, _ = _bound(t_idx, total_w)
    total_w[1] = 0
    half, _ = _bound(t_idx, total_w)
    assert half < full
    total_w[:] = 0
    assert _bound(t_idx, total_w)[0] < half


@pytest.mark.parametrize("B", chip_smoke.DENSE_BATCHES)
def test_dense_bound_is_bytes_at_every_serving_shape(B):
    """Through 3xTF32 tensor-core operations every served Dense layer is
    bound by its bytes (the per-row weights); the SIMT figure is larger."""
    total = simt = 0.0
    for layer, L, n_in, n_out, bias in chip_smoke.DENSE_SHAPES:
        ms, by = chip_smoke._dense_bound_ms(B, L, n_in, n_out, bias)
        simt_ms, _ = chip_smoke._dense_bound_ms(B, L, n_in, n_out, bias,
                                                chip_smoke.F32_FLOPS_PER_S)
        nbytes = 4 * (B * L * n_in + B * n_in * n_out + B * L * n_out
                      + (B * n_out if bias else 0))
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
        assert simt_ms >= ms
        total += chip_smoke.DENSE_PER_FORWARD[layer] * ms
        simt += chip_smoke.DENSE_PER_FORWARD[layer] * simt_ms
    # a b32 forward's nine launches: 0.0281 ms of bytes (SIMT: 0.0309)
    assert total == pytest.approx(0.0281 * B / 32, rel=0.01)
    assert simt > total


@pytest.mark.parametrize("nbytes,flops,by", [(3.35e9, 1.0, "bytes"),
                                             (1.0, 67e9, "operations")])
def test_bound_is_the_larger_of_bytes_and_operations(nbytes, flops, by):
    """1 ms of bytes at 3.35 TB/s or of float32 operations at 67 TFLOP/s."""
    assert chip_smoke._bound(nbytes, flops) == (pytest.approx(1.0), by)


def test_reset_and_read_counts_cover_every_training_kernel():
    from feddrift_torch.kernels.eval_cells import eval_cells, eval_cells_ref
    from feddrift_torch.kernels.fedavg import fedavg, fedavg_ref
    from feddrift_torch.kernels.local_sgd import local_sgd, local_sgd_fedavg
    from feddrift_torch.kernels.lstm_cell import (lstm_cell_bwd,
                                                  lstm_cell_bwd_ref,
                                                  lstm_cell_fwd,
                                                  lstm_cell_fwd_ref)
    from feddrift_torch.kernels.lstm_layer import (lstm_layer_bwd,
                                                   lstm_layer_bwd_ref,
                                                   lstm_layer_fwd,
                                                   lstm_layer_fwd_ref)
    from feddrift_torch.kernels.weighted_draw import (weighted_cdf,
                                                      weighted_cdf_ref,
                                                      weighted_search,
                                                      weighted_search_ref)
    lstm_cell_fwd.launches = lstm_cell_bwd.launches = 10
    lstm_cell_fwd_ref.cuda_calls = lstm_cell_bwd_ref.cuda_calls = 11
    lstm_layer_fwd.launches = lstm_layer_bwd.launches = 12
    lstm_layer_fwd_ref.cuda_calls = lstm_layer_bwd_ref.cuda_calls = 13
    fedavg.launches = eval_cells.launches = 3
    local_sgd.launches = local_sgd_fedavg.launches = 4
    local_sgd.wide_launches = eval_cells.wide_launches = 7
    local_sgd.split_launches = eval_cells.stream_launches = 8
    local_sgd.fused_launches = eval_cells.fused_launches = 9
    local_sgd_fedavg.evals = 6
    weighted_cdf.launches = weighted_search.launches = 5
    fedavg_ref.cuda_calls = eval_cells_ref.cuda_calls = 2
    weighted_cdf_ref.cuda_calls = weighted_search_ref.cuda_calls = 2
    chip_smoke._reset_counts()
    assert chip_smoke._read_counts() == {
        "k1_launches": 0, "k1_without_epilogue": 0, "k1_fused_launches": 0,
        "k1_wide_launches": 0, "k1_split_launches": 0,
        "k1_general_launches": 0,
        "k4a_launches": 0, "k4b_launches": 0, "k2_launches": 0,
        "k2_epilogues": 0, "aggregations": 0, "k3_launches": 0,
        "k3_fused_launches": 0, "k3_wide_launches": 0,
        "k3_stream_launches": 0, "folded_evals": 0,
        "lstm_cell_fwd_launches": 0, "lstm_cell_bwd_launches": 0,
        "lstm_layer_fwd_launches": 0, "lstm_layer_bwd_launches": 0,
        "plain_calls": {"fedavg_ref": 0, "lstm_cell_fwd_ref": 0,
                        "lstm_cell_bwd_ref": 0, "lstm_layer_fwd_ref": 0,
                        "lstm_layer_bwd_ref": 0, "eval_cells_ref": 0,
                        "weighted_cdf_ref": 0, "weighted_search_ref": 0}}


@pytest.mark.parametrize("epilogues,k2,k3,plain", [
    (2000, 0, 410, 0), (1999, 0, 410, 0), (2000, 0, 0, 0), (2000, 0, 410, 1),
    (2000, 1, 410, 0), (0, 2000, 410, 0)])
def test_check_k2_k3_refuses_a_missed_round_or_a_plain_call(epilogues, k2,
                                                            k3, plain):
    """A driven run on the fused route fails unless K2 aggregated every
    round once, in K1's epilogue and with no launch of its own, K3 ran,
    and no plain K2 / K3 / K4 ran on the card; on the general route every
    round is a K2 launch of its own."""
    got = {"k2_launches": k2, "k2_epilogues": epilogues,
           "aggregations": k2 + epilogues, "k3_launches": k3,
           "plain_calls": {"fedavg_ref": 0, "eval_cells_ref": 0,
                           "weighted_cdf_ref": 0,
                           "weighted_search_ref": plain}}
    if (epilogues, k2, k3, plain) == (2000, 0, 410, 0):
        chip_smoke._check_k2_k3("run", got, 2000)
        return
    if (epilogues, k2) == (0, 2000):
        chip_smoke._check_k2_k3("run", got, 2000, k2_launches=2000)
        with pytest.raises(AssertionError, match="K2 aggregated"):
            chip_smoke._check_k2_k3("run", got, 2000)
        return
    with pytest.raises(AssertionError, match="K2 aggregated"):
        chip_smoke._check_k2_k3("run", got, 2000)


def _eval_run(hidden=10, batch=500, T=10, R=200):
    """A run's configuration and a stand-in for its ``Experiment``: the
    module and the dataset's rows a step, which decide the fold."""
    from types import SimpleNamespace

    import torch

    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.models.mlp import FeedForwardNN
    cfg = ExperimentConfig(fnn_hidden_dim=hidden, batch_size=batch,
                           train_iterations=T, comm_round=R)
    exp = SimpleNamespace(step=SimpleNamespace(module=FeedForwardNN(
        (3,), 2, hidden)), x=torch.zeros(10, T + 1, 500, 3))
    return cfg, exp


@pytest.mark.parametrize("hidden,folds,fused_steps,folded,k3,ok", [
    (10, True, 10, 400, 10, True), (10, True, 10, 400, 11, True),
    (10, True, 10, 399, 11, False), (10, True, 10, 400, 9, False),
    (10, True, 0, 0, 410, True), (10, True, 0, 10, 410, False),
    (10, True, 4, 160, 250, True), (32, False, 10, 0, 410, True),
    (32, False, 10, 400, 10, False), (32, True, 10, 0, 410, False),
    (10, False, 10, 0, 410, False)])
def test_check_evals_wants_every_regular_eval_folded(hidden, folds,
                                                     fused_steps, folded,
                                                     k3, ok):
    """Where the shape folds, each fused step folds its 40 regular evals
    into K1 and launches K3 for its final one; a per-round step, or a
    shape that does not fold (H = 32), launches K3 for every eval. A run
    whose shape folds other than the caller wants (``folds``) fails, even
    when its counts agree with what its shape does."""
    cfg, exp = _eval_run(hidden)
    got = {"folded_evals": folded, "k3_launches": k3}
    if ok:
        chip_smoke._check_evals("run", got, cfg, exp, fused_steps, folds)
    else:
        with pytest.raises(AssertionError, match="evals folded"):
            chip_smoke._check_evals("run", got, cfg, exp, fused_steps,
                                    folds)


def test_launches_by_kernel_adds_up_a_template_family():
    """Kernels whose names share their first 60 characters (one template
    family) add their launches under that name, so the names' launches sum
    to the profile's."""
    from types import SimpleNamespace
    family = "void at::native::vectorized_elementwise_kernel<4, at::native"
    kernels = [SimpleNamespace(key=family + "::FillFunctor", count=3),
               SimpleNamespace(key="local_sgd_fused_kernel<3, 10, 2>",
                               count=200),
               SimpleNamespace(key=family + "::CUDAFunctor_add", count=2)]
    got = chip_smoke._launches_by_kernel(kernels)
    assert got == {"local_sgd_fused_kernel<3, 10, 2>": 200, family: 5}
    assert list(got) == ["local_sgd_fused_kernel<3, 10, 2>", family]


def test_draw_bounds_count_the_searched_rows():
    """K4a moves the weights and the cdf; K4b the uniforms, the rows and
    the cdf rows of the pairs that search them, so a masked pair costs
    no cdf bytes; both are bound by bytes at KUE's shape."""
    d = dict(M=4, C=10, T1=11, N=500, S=5, B=500)
    cdf_ms, cdf_by = chip_smoke._cdf_bound_ms(d)
    assert cdf_by == "bytes" and cdf_ms == pytest.approx(
        4 * 40 * (11 + 500 + 5500) / chip_smoke.HBM_BYTES_PER_S * 1e3)
    full, by = chip_smoke._search_bound_ms(d, 40)
    masked, _ = chip_smoke._search_bound_ms(d, 32)
    assert by == "bytes" and masked < full
    assert full - masked == pytest.approx(
        4 * 8 * 5500 / chip_smoke.HBM_BYTES_PER_S * 1e3)


def _ab_runs():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts", "torch_ab_runs.py")
    spec = importlib.util.spec_from_file_location("torch_ab_runs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["canonical", "win-1", "cfl", "aue",
                                  "kue"])
def test_ab_runs_drive_the_smoke_runs_configurations(name):
    """``scripts/torch_ab_runs.py`` compares the runs ``chip_smoke.py``
    drives: the canonical configuration, or one of ``ALGO_RUNS``."""
    from feddrift_torch.config import ExperimentConfig
    algo, arg = _ab_runs().RUNS[name]
    cfg = ExperimentConfig()
    if name == "canonical":
        assert (algo, arg) == (cfg.concept_drift_algo,
                               cfg.concept_drift_algo_arg)
    else:
        assert (algo, arg) in {r[:2] for r in chip_smoke.ALGO_RUNS}


def test_ab_runs_refuse_an_unknown_run_and_a_missing_base():
    import subprocess
    import sys
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts", "torch_ab_runs.py")
    for args in (["--base", ".", "--runs", "canonical,nope"], []):
        proc = subprocess.run([sys.executable, path, *args],
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 2 and not proc.stdout
    assert _ab_runs().ORDER == ("base", "this", "this", "base")


@pytest.mark.parametrize("run", chip_smoke.MNIST_RUNS, ids=lambda r: r[4])
def test_mnist_reference_runs_are_the_committed_ones(run):
    """train_mnist's committed MNIST-4 runs: R = 200, T = 10, one run a
    file, named as the CLI names it; each drives its first T steps."""
    algo, arg, pool, T, name, pinned, step_tol, mean_tol = run
    metrics = os.path.join(os.path.dirname(chip_smoke.REF_RUN), "..", name,
                           "metrics.jsonl")
    assert chip_smoke._reference_accs(metrics, pinned) == list(pinned)
    rows = [json.loads(ln) for ln in open(metrics)]
    assert rows[-1]["round"] == 1999 and rows[-1]["iteration"] == 9
    assert name == f"MNIST-fnn-{algo}-{arg}-s0"
    # the CLI names a run's directory as the committed one is named
    from feddrift_torch.cli import run_dir
    from feddrift_torch.config import ExperimentConfig
    assert run_dir(ExperimentConfig(
        dataset="MNIST", concept_drift_algo=algo, concept_drift_algo_arg=arg,
        concept_num=pool, out_dir="runs")) == os.path.join("runs", name)
    assert T in (5, 10) and mean_tol >= 0.015
    # a clustering decision on noise-driven spawns is held to the mean only
    assert (step_tol is None) == (algo not in ("win-1", "oblivious"))
    assert pool == (10 if "H_A_F" in arg else 4)


def test_mnist_runs_fit_the_time_budget():
    """All five runs at T = 10: 10000 K1 launches (on the wide kernel, well
    under a millisecond a launch on the card); the lr runs 4080 more."""
    assert sum(r[3] for r in chip_smoke.MNIST_RUNS) * 200 == 10000
    assert [r[3] for r in chip_smoke.MNIST_RUNS] == [10, 10, 10, 10, 10]
    assert sum(kw.get("train_iterations", 10) * kw.get("comm_round", 200)
               for _, kw, _, _ in chip_smoke.LR_RUNS) == 4080


def test_k1_cases_run_every_instantiation_of_both_kernels():
    """``K1_CASES`` hold each of the general and the wide kernel's four
    instantiations (the lr or the fnn, AMSGrad or SGD), the split
    kernel's two (the fnn, AMSGrad or SGD) and the fused kernel's at each
    of its widths to the plain version, each
    kernels-line entry of K1 names a case, and the runs held at step 0 only
    are lr runs."""
    from feddrift_torch.kernels.local_sgd import _route
    widths = {"sea": (3, 2), "sine": (2, 2), "MNIST": (784, 10),
              "fmow": (3072, 62), "femnist": (784, 62),
              "stackoverflow_lr": (1000, 50), "susy": (18, 2), "ro": (5, 2),
              "cifar10": (3072, 10)}
    routes, fused = set(), set()
    for label, dataset, _, model, hidden, optimizer, forced, _ \
            in chip_smoke.K1_CASES:
        F, K = widths[dataset]
        H = 0 if model == "lr" else hidden
        routes.add((forced or _route(F, H, K, 500, optimizer), model,
                    optimizer))
        if (forced or _route(F, H, K, 500, optimizer)) == "fused":
            fused.add((F, H, K))
    # and each instantiation of the fused kernel
    from feddrift_torch.kernels.local_sgd import FUSED_WIDTHS
    assert fused == set(FUSED_WIDTHS)
    assert {(r, m, o) for r in ("general", "wide") for m in ("lr", "fnn")
            for o in ("adam", "sgd")} <= routes
    assert {("split", "fnn", "adam"), ("split", "fnn", "sgd")} <= routes
    assert set(chip_smoke.K1_ENTRIES) <= {c[0] for c in chip_smoke.K1_CASES}
    assert {e[0] for e in chip_smoke.K1_ENTRIES.values()} \
        <= set(chip_smoke.WIDE_ENTRIES)
    assert set(chip_smoke.LR_STEP0_RUNS) <= {r[0] for r in chip_smoke.LR_RUNS}


@pytest.mark.parametrize("run", chip_smoke.LR_RUNS, ids=lambda r: r[0])
def test_lr_runs_hold_a_value_a_step(run):
    label, kw, ref, init = run
    assert kw["model"] == "lr" and len(ref) == kw.get("train_iterations", 10)
    assert all(0.0 < a < 1.0 for a in ref)
    if init is not None:
        assert kw["dataset"] == "sea" and kw["seed"] == 7
        assert len(init["Dense_0/kernel"]) == 3 and init["Dense_0/bias"] \
            == (0.0, 0.0)


def test_local_sgd_bound_of_the_lr_and_sgd():
    """The lr's operations (4 F K + 14 K a row) and SGD's update (3 a
    parameter, no optimizer state in the bytes)."""
    dims = dict(M=1, C=1, S=1, B=500, F=784, H=0, K=10)
    rows = torch.arange(500)[None, None, None]
    total_w = torch.ones(1, 1)
    P = 784 * 10 + 10
    for sgd in (False, True):
        ms, by = chip_smoke._local_sgd_bound_ms(rows, total_w, **dims,
                                                index_bytes=8, sgd=sgd)
        flops = 500 * (4 * 784 * 10 + 14 * 10) + (3 if sgd else 14) * P
        nbytes = (500 * (4 * 784 + 4) + P * 4
                  + (0 if sgd else 2 * (3 * P * 4 + 4)) + P * 4 + 8 + 8 + 4)
        want = max(flops / chip_smoke.F32_FLOPS_PER_S,
                   nbytes / chip_smoke.HBM_BYTES_PER_S) * 1e3
        assert ms == pytest.approx(want)
        assert by == ("operations" if flops / chip_smoke.F32_FLOPS_PER_S
                      > nbytes / chip_smoke.HBM_BYTES_PER_S else "bytes")


def test_lr_near_ties_separate_solid_ties():
    """For the lr: a row whose two top outputs saturate from z >= 20 is a
    solid tie (not a near tie); one with a class z in [15, 20) is a near
    tie; a row with a clear winner is neither."""
    from feddrift_torch.models.mlp import LogisticRegression
    F, K = 2, 3
    mod = LogisticRegression((F,), K)
    # z = x W + b per class; x picks the row's z through two features
    w = torch.tensor([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    flat = mod.pack({"Dense_0/kernel": w,
                     "Dense_0/bias": torch.zeros(K)})[None]
    x = torch.tensor([[25.0, 0.0],       # z = (25, 25, 0): solid tie
                      [25.0, 17.0],      # z = (25, 25, 17): flip band
                      [3.0, 0.0],        # z = (3, 3, 0): an exact tie, low z
                      [0.0, 2.0]])       # z = (0, 0, 2): clear winner
    ties, solid = chip_smoke._near_ties(flat, x[None, None], None, F, 0, K)
    assert solid.tolist() == [[[1]]]
    assert ties.tolist() == [[[2]]]


def test_mnist_reference_init_is_the_reference_pools():
    """train_mnist's initial params are what the JAX package's runner puts
    in every slot of the MNIST-4 fnn pool at seed 0 (ModelPool.create with
    seed 42), bitwise, packed in param_specs order."""
    import jax
    import numpy as np

    from feddrift_torch.convert import params_from_jax
    from feddrift_torch.models.mlp import FeedForwardNN
    from feddrift_tpu.config import ExperimentConfig as JaxConfig
    from feddrift_tpu.simulation.runner import Experiment as JaxExperiment
    exp = JaxExperiment(JaxConfig(dataset="MNIST", train_iterations=1,
                                  sample_num=10))
    mod = FeedForwardNN((784,), 10, 10)
    want = mod.pack(params_from_jax(jax.tree_util.tree_map(
        np.asarray, exp.pool.init_params), "cpu"))
    got = np.load(chip_smoke.MNIST_REFERENCE_INIT)
    assert got.dtype == np.float32 and got.shape == (mod.num_params,)
    assert np.array_equal(got, want.numpy())
    slots = jax.tree_util.tree_map(np.asarray, exp.pool.params)
    assert np.array_equal(mod.pack(params_from_jax(slots, "cpu"))[-1].numpy(),
                          got)


def _fused_tabular_got(**over):
    """The counts of a 10-step susy run on the fused route: 2000 fused K1
    launches each with its epilogue, 400 folded evals, 10 fused K3
    launches; ``over`` replaces some."""
    got = {"k1_launches": 2000, "k1_without_epilogue": 0,
           "k1_fused_launches": 2000, "k1_wide_launches": 0,
           "k1_split_launches": 0, "k1_general_launches": 0,
           "k4a_launches": 0, "k4b_launches": 0, "k2_launches": 0,
           "k2_epilogues": 2000, "aggregations": 2000, "k3_launches": 10,
           "k3_fused_launches": 10, "k3_wide_launches": 0,
           "k3_stream_launches": 0, "folded_evals": 400,
           "plain_calls": {"fedavg_ref": 0, "eval_cells_ref": 0,
                           "weighted_cdf_ref": 0, "weighted_search_ref": 0},
           "paths": ["fused"] * 10}
    got.update(over)
    return got


@pytest.mark.parametrize("over,ok", [
    ({}, True),
    ({"k1_fused_launches": 0, "k1_general_launches": 2000,
      "k2_epilogues": 0, "aggregations": 2000, "k2_launches": 2000,
      "folded_evals": 0, "k3_launches": 410, "k3_fused_launches": 0}, False),
    ({"k1_launches": 2001, "k1_general_launches": 1}, False),
    ({"k3_fused_launches": 9}, False),
    ({"folded_evals": 399, "k3_launches": 11, "k3_fused_launches": 11},
     False),
    ({"k2_launches": 1, "aggregations": 2001}, False),
    ({"paths": ["fused"] * 9 + ["per_round"]}, False)],
    ids=["fused", "general", "one_general", "k3_elsewhere", "one_unfolded",
         "fedavg_launch", "per_round_step"])
def test_check_fused_tabular_run(over, ok):
    """A susy or ro run passes only where every round was one fused K1
    launch with K2 as its epilogue (no fedavg.cu, no general K1), every
    eval but a step's last folded, and those last ones on K3's fused
    kernel."""
    from types import SimpleNamespace

    import torch

    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.models.mlp import FeedForwardNN
    cfg = ExperimentConfig(dataset="susy", train_iterations=10)
    exp = SimpleNamespace(step=SimpleNamespace(module=FeedForwardNN(
        (18,), 2, 10)), x=torch.zeros(10, 11, 500, 18))
    got = _fused_tabular_got(**over)
    if ok:
        chip_smoke._check_fused_tabular_run("susy", got, cfg, exp, 2000)
    else:
        with pytest.raises(AssertionError):
            chip_smoke._check_fused_tabular_run("susy", got, cfg, exp, 2000)


def test_rotating_calls_take_each_input_set_in_turn():
    """The cell's timed calls cycle through their copies of the inputs."""
    seen = []
    call = chip_smoke._rotating([(1, "a"), (2, "b"), (3, "c")],
                                lambda n, s: seen.append((n, s)))
    for _ in range(7):
        call()
    assert [n for n, _ in seen] == [1, 2, 3, 1, 2, 3, 1]


def test_cell_bounds_hold_more_than_l2_and_count_the_functions_words():
    """The cold copies of a cell case's inputs exceed the H100's 50 MB L2
    twice over; the bounds count the words the function reads and writes
    (forward 7 a (row, unit), not the 11 the kernel also writes for the
    backward), and both bounds are bytes at the cases' shapes."""
    assert chip_smoke.CELL_COLD_BYTES >= 2 * 50 * 10**6
    assert chip_smoke.CELL_COST["fwd"][0] == 4 + 1 + 2
    assert chip_smoke.CELL_COST["bwd"][0] == 2 + 4 + 2 + 4 + 1
    for _, R, H in chip_smoke.RNN_CELL_CASES:
        for words, ops in chip_smoke.CELL_COST.values():
            assert chip_smoke._bound(words * R * H * 4,
                                     ops * R * H)[1] == "bytes"


def test_sample_gate_holds_the_means_within_the_standard_error():
    """A seed sample's column passes where the card's mean over the seeds
    lies within max(floor, CONV_SAMPLE_SE_FACTOR x the standard error of
    the two means' difference) of the reference's, and fails outside."""
    import math
    card = [[0.70, 0.95], [0.74, 0.97], [0.72, 0.93], [0.66, 0.95]]
    ref = [[0.60, 0.94], [0.70, 0.96], [0.72, 0.94], [0.68, 0.96]]
    rows = chip_smoke._sample_gate(card, ref, [0.04, 0.015])
    c_mean, r_mean = 0.705, 0.675
    c_var = sum((c[0] - c_mean) ** 2 for c in card) / 3 / 4
    r_var = sum((r[0] - r_mean) ** 2 for r in ref) / 3 / 4
    tol = chip_smoke.CONV_SAMPLE_SE_FACTOR * math.sqrt(c_var + r_var)
    assert rows[0]["card_mean"] == pytest.approx(c_mean)
    assert rows[0]["reference_mean"] == pytest.approx(r_mean)
    assert rows[0]["tol"] == pytest.approx(max(0.04, tol))
    assert rows[0]["within"] and rows[1]["within"]
    # the floor holds where the seeds agree; a shift past it fails
    same = [[0.7, 0.9]] * 3
    assert chip_smoke._sample_gate(same, same, [0.04, 0.015])[0]["tol"] \
        == 0.04
    shifted = [[0.75, 0.9]] * 3
    got = chip_smoke._sample_gate(shifted, same, [0.04, 0.015])
    assert not got[0]["within"] and got[1]["within"]
