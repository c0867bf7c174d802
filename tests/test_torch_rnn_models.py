"""The port's LSTMs (``models/rnn.py``: ``rnn``, ``rnn_stackoverflow``)
against the JAX package's flax modules on the CPU, and their training
through ``TrainStep``'s model-generic path.

- Leaves: flax's names, shapes and creation order's set, the published
  sizes (820,522 params at V 90; 4,050,748 at V 10000), the orthogonal
  recurrent kernels, a flax tree carried across by ``params_from_jax``.
- Logits and ``jax.grad`` gradients of the cross entropy, from the same
  params, on seeded token rows: at small widths (H 16, V 12, seq 6) and at
  full width, within 1e-5 of the reference's largest magnitude (float32
  sums in other orders through 6 to 80 recurrent steps; ~1e-6 measured).
- One round of CharLSTM (small widths) against the JAX ``TrainStep`` on its
  draws, and the eval matrices, with the tolerances of
  ``test_torch_conv_step.py``: params, the client stack and mu within 1e-6
  but for at most 1e-3 of them (AMSGrad's first steps divide by a
  rounding-level nu: 3 of 8024 params moved 4.7e-6 apart), each within
  the most S steps move one; nu within 1e-4 relative, losses 1e-5, n and
  stats exact; the eval counts within one row, NLL and Brier sums 1e-4
  relative.
- KUE on a sequence dataset: its masks are ``[M, 1]`` ones (the JAX
  package's ``feature_mask_for``), and a round under them is bitwise the
  round without a mask.
- A short AUE run on fed_shakespeare (4 clients, 2 steps of 2 rounds, seq
  6, N 16) in both packages, the port from the reference's pool and on
  its draws (``test_torch_statebased.py::run_both``): every eval's
  Test/Acc and Train/Acc within one sample of the 64 an eval scores
  (1/64; equal when measured), its Test/Loss within 1e-2 (~2e-6
  measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.convert import params_from_jax
from feddrift_torch.core.functional import cross_entropy
from feddrift_torch.core.step import TrainStep
from feddrift_torch.data.drift_dataset import DriftDataset
from feddrift_torch.models import UNPORTED, create_model
from feddrift_torch.models.base import GenericNet
from feddrift_torch.models.rnn import CharLSTM, WordLSTM
from test_torch_conv_step import STEP_BOUND, _close_but_flips
from test_torch_statebased import _reference_draws, run_both
from test_torch_train_step import _opt_to_port, _pack

TOL = 1e-5
M, C, T, N, B, S, K, L, LR, WD = 2, 3, 2, 12, 4, 2, 12, 6, 0.01, 0.001
ATOL, NU_RTOL, LOSS_ATOL, NLL_RTOL = 1e-6, 1e-4, 1e-5, 1e-4


def _jax(name, **kw):
    from feddrift_tpu.models.rnn import CharLSTM as JC
    from feddrift_tpu.models.rnn import WordLSTM as JW
    return (JC if name == "rnn" else JW)(**kw)


# (port module, reference module, vocabulary the tokens draw from, seq)
CASES = {
    "rnn_small": (lambda: CharLSTM((L,), K, hidden_size=16),
                  lambda: _jax("rnn", vocab_size=K, hidden_size=16), K, L),
    "rnn_stackoverflow_small": (
        lambda: WordLSTM((L,), K, embedding_size=8, latent_size=16),
        lambda: _jax("rnn_stackoverflow", vocab_size=K, embedding_size=8,
                     latent_size=16), K + 4, L),
    "rnn": (lambda: CharLSTM((80,), 90), lambda: _jax("rnn"), 90, 80),
    "rnn_stackoverflow": (lambda: WordLSTM((20,), 10000),
                          lambda: _jax("rnn_stackoverflow"), 10004, 20)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(params):
    return unflatten_dict({tuple(k.split("/")): v.numpy()
                           for k, v in params.items()})


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _seq_ds(name, V, seq=L):
    return DriftDataset(x=np.zeros((1, 1, 1, seq), np.int32),
                        y=np.zeros((1, 1, 1), np.int32),
                        concepts=np.zeros((1, 1), np.int64), num_classes=V,
                        name=name, is_sequence=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_leaves_are_flaxs(case):
    make, jmake, _, seq = CASES[case]
    mod, jm = make(), jmake()
    specs = mod.param_specs()
    jp = flatten_dict(jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, seq), jnp.int32)),
        jax.random.PRNGKey(0))["params"], sep="/")
    assert {k: tuple(v.shape) for k, v in jp.items()} == \
        {k: shape for k, (shape, _) in specs.items()}
    assert isinstance(mod, GenericNet)


def test_registry_builds_both_at_published_sizes():
    cfg = ExperimentConfig()
    rnn = create_model("rnn", _seq_ds("shakespeare", 90, 80), cfg)
    so = create_model("rnn_stackoverflow",
                      _seq_ds("stackoverflow_nwp", 10000, 20), cfg)
    assert (rnn.num_params, so.num_params) == (820522, 4050748)
    assert (rnn.num_classes, so.num_classes) == (90, 10004)
    assert not {"rnn", "rnn_stackoverflow"} & set(UNPORTED)


@pytest.mark.parametrize("case", ["rnn_small", "rnn_stackoverflow_small"])
def test_pool_apply_rows_is_each_rows_own_forward(case):
    """``ModelPool.apply_rows`` on an LSTM (``pair_logits`` with a pair a
    row, no ``vmap``): each row's logits are its own model's forward on it
    alone, within 1e-6."""
    from feddrift_torch.core.pool import ModelPool
    make, _, V, seq = CASES[case]
    mod = make()
    x = torch.randint(0, V, (4, seq),
                      generator=torch.Generator().manual_seed(0))
    pool = ModelPool.create(mod, x[:2], 3, seed=1, identical=False,
                            device="cpu")
    which = (0, 2, 2, 1)
    rows = {k: p[torch.tensor(which)] for k, p in pool.params.items()}
    got = pool.apply_rows(rows, x)
    for i, m in enumerate(which):
        torch.testing.assert_close(got[i], mod(pool.slot(m), x[i:i + 1])[0],
                                   rtol=1e-6, atol=1e-6)


def test_eval_logits_in_pieces_equal_one_forward(monkeypatch):
    """``model_logits`` on an LSTM in forwards of ``EVAL_ROWS`` rows (here
    5, the pieces crossing groups of rows) equals one forward over every
    row, within 1e-6: the rows are independent."""
    import feddrift_torch.core.functional as fn
    mod = CASES["rnn_small"][0]()
    gen = torch.Generator().manual_seed(2)
    params = torch.stack([mod.pack(mod.init_params(gen, "cpu"))
                          for _ in range(2)])
    x = torch.randint(0, K, (3, 2, 4, L), generator=gen, dtype=torch.int32)
    whole = fn.model_logits(mod, params, x)
    monkeypatch.setattr(fn, "EVAL_ROWS", 5)
    pieces = fn.model_logits(mod, params, x)
    assert whole.shape == (2, 3, 2, 4, K)
    torch.testing.assert_close(pieces, whole, rtol=1e-6, atol=1e-6)


def test_init_draws_as_flax_draws():
    """Orthogonal recurrent kernels, lecun-normal input kernels and
    embeddings at flax's scales (the std of n draws within 6 / sqrt(n) of
    flax's draw's, over 4 sigma of the two estimates' spread), zero
    biases; ``params_from_jax`` carries a flax tree across unchanged."""
    mod, jm = CASES["rnn"][0](), CASES["rnn"][1]()
    p = mod.init_params(torch.Generator().manual_seed(0), "cpu")
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80), jnp.int32))
    flat = flatten_dict(jp["params"], sep="/")
    for k, v in p.items():
        want = np.asarray(flat[k])
        if k.endswith("bias"):
            assert not v.any() and not want.any()
            continue
        # a sample std's relative spread is ~1/sqrt(2n) for n draws
        assert abs(float(v.std()) / want.std() - 1) < 6 / np.sqrt(
            v.numel()), k
        if "/h" in k:
            eye = v.T @ v
            assert (eye - torch.eye(eye.shape[0])).abs().max() < 1e-5, k
    back = params_from_jax(jax.tree_util.tree_map(np.asarray, jp["params"]),
                           "cpu")
    assert all(np.array_equal(back[k].numpy(), flat[k]) for k in flat)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_gradients_match_flax(case):
    make, jmake, V, seq = CASES[case]
    mod, jm = make(), jmake()
    params = mod.init_params(torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(1)
    x = rng.integers(0, V, (5, seq)).astype(np.int32)
    y = rng.integers(0, V, 5).astype(np.int32)
    from feddrift_tpu.core.functional import cross_entropy as jce

    def reference(p):
        def loss(p):
            return jce(jm.apply({"params": p}, jnp.asarray(x)),
                       jnp.asarray(y))
        return jm.apply({"params": p}, jnp.asarray(x)), jax.grad(loss)(p)
    jlogits, jgrad = jax.jit(reference)(_tree(params))
    flat = mod.pack(params).requires_grad_(True)
    # tokens arrive as float after a feature mask
    logits = mod(mod.unpack(flat), torch.from_numpy(x).float())
    grad, = torch.autograd.grad(cross_entropy(logits, torch.from_numpy(y)),
                                flat)
    want = mod.pack(params_from_jax(jax.tree_util.tree_map(np.asarray, jgrad),
                                    "cpu"))
    assert _rel(logits.detach(), jlogits) <= TOL
    assert _rel(grad, want) <= TOL


# ----------------------------------------------------------------------
# TrainStep's round and evals against the reference's

def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, K, (C, T + 1, N, L)).astype(np.int32)
    y = ((x[..., -1] * 5 + 3) % K).astype(np.int32)   # a learnable rule
    return x, y


def _time_w():
    tw = np.ones((M, C, T + 1), np.float32)
    tw[:, :, T] = 0.0
    tw[1, 2, :] = 0.0                      # an inactive pair
    return tw


def _setup(seed=0):
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    mod = CASES["rnn_small"][0]()
    gen = torch.Generator().manual_seed(seed)
    draws = [mod.init_params(gen, "cpu") for _ in range(M)]
    params = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v.numpy())
                           for k, v in params.items()})
    jm = CASES["rnn_small"][1]()
    jstep = JStep(lambda p, x: jm.apply({"params": p}, x),
                  make_optimizer("adam", LR, WD), B, S, K)
    return mod, params, jstep, tree


def _close(a, b, atol=ATOL, rtol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


def test_round_matches_reference():
    x, y = _data()
    tw = _time_w()
    mod, params, jstep, tree = _setup()
    key = jax.random.PRNGKey(7)
    M_ = tw.shape[0]
    jout = jstep.train_round(
        tree, jstep.init_opt_states(tree, M_, C), key, jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(tw), jnp.ones((M_, C, N)),
        jnp.ones((M_, 1)), jnp.float32(1.0), with_agg_stats=True)
    step = TrainStep(mod, B, S, K, lr=LR, wd=WD, device="cpu")
    assert step.generic
    newp, opt, client, n, losses, stats = step.train_round(
        params, step.init_opt_states(params, M_, C), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(tw),
        draws=_reference_draws(key, tw, S, B, N, False),
        with_agg_stats=True)
    jnewp, jo, jclient, jn, jloss, jstats, _ = jout
    _close_but_flips(mod.pack(newp), _pack(mod, jnewp), bound=STEP_BOUND)
    _close_but_flips(mod.pack(client), _pack(mod, jclient),
                     bound=STEP_BOUND)
    want = _opt_to_port(mod, jo)
    _close_but_flips(opt["mu"], want["mu"])
    for k in ("nu", "nu_max"):
        _close_but_flips(opt[k], want[k], rtol=NU_RTOL,
                         atol=NU_RTOL * float(want[k].abs().max()))
    _close(n, jn, atol=0)
    _close(losses, jloss, atol=LOSS_ATOL)
    _close(stats, jstats, atol=0)
    assert torch.equal(mod.pack(client)[1, 2], mod.pack(params)[1])


def test_eval_matrices_match_reference():
    x, y = _data(1)
    mod, params, jstep, tree = _setup(seed=2)
    step = TrainStep(mod, B, S, K, device="cpu")
    ones = jnp.ones((M, 1))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)

    def counts(got, want):
        assert np.abs(np.asarray(got, np.int64)
                      - np.asarray(want, np.int64)).max() <= 1

    correct, nll, total = step.acc_matrix(params, xt[:, 1], yt[:, 1])
    jc, jl, jt = jstep.acc_matrix(tree, jx[:, 1], jy[:, 1], ones)
    counts(correct, jc)
    _close(nll, jl, atol=0, rtol=NLL_RTOL)
    assert np.array_equal(total.numpy(), np.asarray(jt))
    counts(step.acc_cells(params, xt, yt),
           jstep.acc_cells(tree, jx, jy, ones))
    mse, _ = step.mse_matrix(params, xt[:, 0], yt[:, 0])
    _close(mse, jstep.mse_matrix(tree, jx[:, 0], jy[:, 0], ones)[0], atol=0,
           rtol=NLL_RTOL)
    w = np.array([0.7, 0.3], np.float32)
    for mode in ("hard", "soft"):
        got = step.ensemble_eval(params, xt[:, 0], yt[:, 0],
                                 torch.from_numpy(w), mode)
        want = jstep.ensemble_eval(tree, jx[:, 0], jy[:, 0], jnp.asarray(w),
                                   mode, feat_mask=ones)
        counts(got[0], want[0])


# ----------------------------------------------------------------------
# KUE's masks on a sequence dataset, and a short AUE run

def test_kue_masks_on_a_sequence_dataset_are_ones():
    from feddrift_torch.simulation.runner import Experiment
    cfg = ExperimentConfig(dataset="fed_shakespeare", model="rnn",
                           concept_drift_algo="kue", text_seq_len=L,
                           sample_num=8, batch_size=4, comm_round=1,
                           train_iterations=1, epochs=1,
                           client_num_in_total=2, client_num_per_round=2)
    exp = Experiment(cfg, device="cpu")
    algo = exp.algo
    assert algo.F == 1 and algo.masks.shape == (exp.pool.num_models, 1)
    algo.begin_iteration(0)
    tw, sw, fm, _ = algo.round_inputs(0, 0)
    assert fm.shape == (exp.pool.num_models, 1) and bool((fm == 1).all())
    step, params = exp.step, exp.pool.params
    Mk = exp.pool.num_models
    opt = step.init_opt_states(params, Mk, exp.C_)
    u = step.draw_row_uniforms(Mk, exp.C_, exp.x.shape[2])
    outs = [step.train_round(params, opt, exp.x, exp.y, tw, sample_w=sw,
                             feat_mask=mask, draws=u)
            for mask in (fm, None)]
    for a, b in zip(outs[0][0].values(), outs[1][0].values()):
        assert torch.equal(a, b)


def test_short_aue_run_tracks_the_reference():
    exp, jexp = run_both(
        "aue", dataset="fed_shakespeare", model="rnn", concept_num=3,
        change_points="rand", client_num_in_total=4,
        client_num_per_round=4, train_iterations=2, comm_round=2,
        epochs=1, batch_size=8, sample_num=16, text_seq_len=L, lr=0.03,
        frequency_of_the_test=1)
    ours, ref = exp.logger.history, jexp.logger.history
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert (a["iteration"], a["round"]) == (b["iteration"], b["round"])
        for key in ("Test/Acc", "Train/Acc"):
            assert abs(a[key] - b[key]) <= 1 / 64 + 1e-9, key
        assert abs(a["Test/Loss"] - b["Test/Loss"]) <= 1e-2


# ----------------------------------------------------------------------
# the committed run's configuration (scripts/run_round4_cpu.sh)

def _committed_args(name):
    import os
    import re
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(repo, "scripts", "run_round4_cpu.sh")).read()
    text = text.replace("\\\n", " ")
    return re.search(rf"^run {re.escape(name)} (.*)$", text,
                     re.M).group(1).split()


def test_smoke_drives_the_committed_configuration():
    """``chip_smoke.RNN_RUNS`` is the committed command line as the CLI
    parses it, but for its lr: the script says 0.1, the run was made at
    the 0.03 PARITY.md records (0.1 stays on the most common character);
    pinned to the committed file's final Test/Acc, and gated."""
    import argparse
    import json
    import os

    import chip_smoke
    from feddrift_torch.cli import _add_run_args, _cfg_from_args
    parser = argparse.ArgumentParser()
    _add_run_args(parser)
    for run, kw, pinned, _ in chip_smoke.RNN_RUNS:
        cfg = _cfg_from_args(parser.parse_args(_committed_args(run)))
        want = {k: getattr(cfg, k) for k in kw}
        assert want["lr"] == 0.1 and kw["lr"] == 0.03
        assert kw == dict(want, lr=0.03), run
        path = os.path.join(os.path.dirname(chip_smoke.__file__), "runs",
                            run, "metrics.jsonl")
        final = {}
        for line in open(path):
            rec = json.loads(line)
            final[rec["iteration"]] = rec["Test/Acc"]
        assert tuple(final[t] for t in sorted(final)) == pinned
        step, mean = chip_smoke._rnn_gate(run)
        assert step >= chip_smoke.STEP_ACC_TOL
        assert mean >= chip_smoke.MEAN_ACC_TOL
    so = chip_smoke.RNN_SO_RUN
    assert (so["dataset"], so["model"]) == ("stackoverflow_nwp",
                                            "rnn_stackoverflow")


@pytest.mark.parametrize("which", ["rnn", "rnn_stackoverflow"])
def test_cli_runs_both_models_cut(which, tmp_path):
    """``python -m feddrift_torch run`` of the committed configuration
    (and of ``RNN_SO_RUN``'s), cut to one round of two steps on 8 rows
    (seq 6 for the characters): every step evaluated, the Test/Acc a
    fraction."""
    import chip_smoke
    from feddrift_torch.cli import main
    if which == "rnn":
        args = _committed_args(chip_smoke.RNN_RUNS[0][0]) + [
            "--lr", "0.03", "--text_seq_len", str(L)]
    else:
        args = [f"--{k}={v}" for k, v in chip_smoke.RNN_SO_RUN.items()]
    args += ["--train_iterations", "2", "--comm_round", "1", "--epochs",
             "1", "--sample_num", "8", "--batch_size", "4",
             "--client_num_in_total", "2", "--client_num_per_round", "2"]
    assert main(["run", "--platform", "cpu", "--out_dir", str(tmp_path),
                 *args]) == 0
    import glob
    import json
    lines = [json.loads(ln) for p in glob.glob(str(tmp_path / "*" /
                                                   "metrics.jsonl"))
             for ln in open(p)]
    assert sorted({r["iteration"] for r in lines}) == [0, 1]
    assert all(0.0 <= r["Test/Acc"] <= 1.0 for r in lines)
