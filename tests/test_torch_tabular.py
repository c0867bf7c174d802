"""The tabular datasets in the port against the JAX package on the CPU:
their data (``data/tabular.py``: UCI SUSY / RO, synthetic and from a CSV the
test writes, and stackoverflow_lr's synthetic bag of words), K1's and K3's
plain versions at susy's and stackoverflow_lr's fnn, a short run through
``Experiment``, the reference inits that ``chip_smoke.py``'s
``train_tabular`` starts from, and the runs it holds the card to.

Both packages draw from numpy ``default_rng`` in the same order, so the
arrays are compared bitwise. stackoverflow_lr's fnn runs at a small
vocabulary (64 words, 8 tags) here; its defaults (1000 words, 50 tags)
are held bitwise on 2 clients and 1 step. The round runs on the
reference's own batch draws (its fold_in key path, as
``tests/test_torch_fmow.py`` reproduces it).

Tolerances (float32), as ``tests/test_torch_fmow.py`` states them: after a
round losses, mu and (SGD) params at atol 2e-6, nu and nu_max at rtol 1e-4,
AMSGrad's params at atol 2e-5; n exactly. The eval: counts exactly, NLL sums
at rtol 1e-5. A run: step 0 trains on the same batches in both packages
(N = B), so its logged evals agree to 1e-4 on accuracies and 1e-3 on
losses.
"""

import csv

import numpy as np
import pytest
import torch

import chip_smoke
from feddrift_torch.config import ExperimentConfig as TorchConfig
from feddrift_torch.convert import params_from_jax
from feddrift_torch.core.step import TrainStep
from feddrift_torch.data import tabular as ttab
from feddrift_torch.data.registry import available_datasets
from feddrift_torch.data.registry import make_dataset as torch_make
from feddrift_torch.kernels.eval_cells import eval_cells
from feddrift_torch.kernels.local_sgd import init_opt_state, local_sgd_ref
from feddrift_torch.models.mlp import FeedForwardNN
from feddrift_tpu.config import ExperimentConfig as JaxConfig
from feddrift_tpu.data import tabular as jtab
from feddrift_tpu.data.registry import make_dataset as jax_make
from test_torch_fmow import _jax_draws, _time_w
from torch_threads import one_intra_op_thread  # noqa: F401


# the round's sizes are test_torch_fmow's, whose time weights and
# reference draws (_time_w, _jax_draws) it reuses
M, C, T, N, B, S, H = 2, 3, 2, 40, 20, 3, 10
LR, WD = 0.05, 0.001
ATOL, ADAM_PARAM_ATOL, NU_RTOL, NLL_RTOL = 2e-6, 2e-5, 1e-4, 1e-5
ACC_ATOL, LOSS_ATOL = 1e-4, 1e-3
SMALL_SO = dict(so_vocab_size=64, so_tag_size=8)
# (dataset, extra config, F, K) of the narrow fnn cases
WIDTHS = {"susy": ({}, 18, 2), "ro": ({}, 5, 2),
          "stackoverflow_lr": (SMALL_SO, 64, 8)}
# N = B of the rounds and runs on K1's fused route at susy's and ro's
# widths: its block (a thread a row) needs a thread for each of the P + 1
# values (susy's 213), so the fused round starts at B = 193
FUSED_ROWS = 224


def _same(got, want):
    assert got.x.dtype == np.float32 and got.y.dtype == np.int32
    assert np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)
    assert np.array_equal(got.concepts, want.concepts)
    assert got.num_classes == want.num_classes
    assert got.meta == want.meta and got.name == want.name


# --------------------------------------------------------------------------
# The data

def test_registry_and_defaults():
    assert {"susy", "ro", "stackoverflow_lr"} <= set(available_datasets())
    assert {"stackoverflow", "stackoverflow_nwp"} \
        <= set(available_datasets())
    assert TorchConfig().so_vocab_size == JaxConfig().so_vocab_size == 1000
    assert TorchConfig().so_tag_size == JaxConfig().so_tag_size == 50
    assert ttab.UCI_SPECS == jtab.UCI_SPECS


@pytest.mark.parametrize("dataset", ["susy", "ro"])
@pytest.mark.parametrize("noise,seed,points", [
    (0.0, 0, "A"), (0.1, 3, "A"), (0.05, 1, "rand")])
def test_uci_synthetic_bitwise_equals_reference(dataset, noise, seed, points):
    kw = dict(dataset=dataset, train_iterations=3, sample_num=30,
              noise_prob=noise, seed=seed, change_points=points)
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert got.x.shape == (10, 4, 30, ttab.UCI_SPECS[dataset][0])
    assert got.meta == {"source": "synthetic"}
    _same(got, want)


def _write_csv(root, dataset, rows=700):
    """The reference's CSV layout of ``dataset`` under ``root``, with a
    header and a row that fails to parse."""
    F, name = ttab.UCI_SPECS[dataset]
    rng = np.random.default_rng(11)
    with open(root / name, "w", newline="") as f:
        w = csv.writer(f)
        if dataset == "susy":
            w.writerow(["label"] + [f"f{i}" for i in range(F)])
        else:
            w.writerow(["id", "date"] + [f"f{i}" for i in range(F)]
                       + ["Occupancy"])
        for i in range(rows):
            feats = [f"{v:.6f}" for v in rng.normal(size=F)]
            label = str(int(rng.integers(0, 2)))
            if i == 5:
                feats[2] = "nan?"            # malformed: skipped whole
            w.writerow([label + ".0"] + feats if dataset == "susy"
                       else [str(i), "2015-02-04 17:51:00"] + feats
                       + [label])


@pytest.mark.parametrize("dataset", ["susy", "ro"])
@pytest.mark.parametrize("noise,rows", [(0.0, 700), (0.2, 700), (0.0, 90)])
def test_uci_csv_bitwise_equals_reference(tmp_path, dataset, noise, rows):
    """The CSV's rows standardised and sliced per (client, step) in file
    order (wrapping where the file is short), drifted concepts flipping
    their half-space's labels: the header and the malformed row skipped as
    the reference skips them."""
    _write_csv(tmp_path, dataset, rows)
    kw = dict(dataset=dataset, train_iterations=2, sample_num=20,
              noise_prob=noise, data_dir=str(tmp_path))
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert got.meta == {"source": "csv"}
    _same(got, want)
    F, name = ttab.UCI_SPECS[dataset]
    for a, b in zip(ttab._load_uci_csv(str(tmp_path / name), dataset, F, 50),
                    jtab._load_uci_csv(str(tmp_path / name), dataset, F, 50)):
        assert np.array_equal(a, b) and len(a) == 50


@pytest.mark.parametrize("noise,seed", [(0.0, 0), (0.1, 2)])
def test_stackoverflow_lr_small_bitwise_equals_reference(noise, seed):
    kw = dict(dataset="stackoverflow_lr", train_iterations=2, sample_num=25,
              noise_prob=noise, seed=seed, **SMALL_SO)
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert got.x.shape == (10, 3, 25, 64) and got.num_classes == 8
    _same(got, want)


def test_stackoverflow_lr_defaults_bitwise_equal_reference():
    kw = dict(dataset="stackoverflow_lr", client_num_in_total=2,
              client_num_per_round=2, train_iterations=1, sample_num=40)
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert got.x.shape == (2, 2, 40, 1000) and got.num_classes == 50
    assert got.x.sum(-1).max() == 30.0      # 30 word draws a sample
    _same(got, want)


# --------------------------------------------------------------------------
# K1 and K3's plain versions at susy's and a small stackoverflow_lr's fnn,
# on the reference's draws

def _data(dataset, seed, n=N):
    extra, F, _ = WIDTHS[dataset]
    ds = jax_make(JaxConfig(dataset=dataset, train_iterations=T, sample_num=n,
                            seed=seed, **extra))
    x = ds.x[:C].reshape(C, T + 1, n, F)
    return np.ascontiguousarray(x), np.ascontiguousarray(ds.y[:C])


def _jax_pool(seed, F, K):
    import jax
    import jax.numpy as jnp

    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    jm = JFnn(num_classes=K, hidden_dim=H)
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    jp = jax.vmap(lambda k: jm.init(k, jnp.zeros((1, F)))["params"])(keys)
    return jm, jax.tree_util.tree_map(np.asarray, jp)


def _jax_step(jm, optimizer, K, b=B):
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    return JStep(lambda p, x: jm.apply({"params": p}, x),
                 make_optimizer(optimizer, LR, WD), b, S, K)


def _pack(tree, F, K):
    import jax
    return FeedForwardNN((F,), K, H).pack(params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), "cpu"))


@pytest.fixture(scope="module", params=[
    ("susy", "adam", N), ("susy", "sgd", N), ("stackoverflow_lr", "adam", N),
    ("stackoverflow_lr", "sgd", N), ("susy", "adam", FUSED_ROWS),
    ("ro", "adam", FUSED_ROWS)],
    ids=lambda p: f"{p[0]}-{p[1]}" + ("-fused" if p[2] == FUSED_ROWS else ""))
def jax_round(request):
    """One reference train_round at the dataset's narrow fnn, with its
    draws and masks (model 1 off on every third input); at N = B =
    FUSED_ROWS (the "-fused" cases) the port's round takes K1's fused
    route with K2 as its epilogue."""
    import jax
    import jax.numpy as jnp
    dataset, optimizer, n = request.param
    b = B if n == N else n
    _, F, K = WIDTHS[dataset]
    seed = 1 if optimizer == "adam" else 2
    x, y = _data(dataset, seed, n)
    tw = _time_w(seed)
    fm = np.ones((M, F), np.float32)
    fm[1, ::3] = 0.0
    jm, jp = _jax_pool(seed, F, K)
    jstep = _jax_step(jm, optimizer, K, b)
    key = jax.random.PRNGKey(30 + seed)
    out = jstep.train_round(
        jp, jstep.init_opt_states(jp, M, C), key, jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(tw), jnp.ones((M, C, n)), jnp.asarray(fm),
        jnp.float32(0.5), with_agg_stats=True)
    t_idx, slot = _jax_draws(key, tw)
    if n == b:     # the reference's slot draw is randint(0, N // B) = 0
        slot = torch.zeros_like(slot)
    return dict(optimizer=optimizer, F=F, K=K, N=n, B=b, x=x, y=y, tw=tw,
                fm=fm, jp=jp, out=out, draws=(t_idx, slot))


def test_local_sgd_ref_matches_reference(jax_round):
    """Client params, optimizer state, n and loss of every pair against
    ``_local_sgd``, with feature masks and lr_scale 0.5."""
    r = jax_round
    F, K = r["F"], r["K"]
    flat = _pack(r["jp"], F, K)
    client, opt, n, loss = local_sgd_ref(
        torch.from_numpy(r["x"]), torch.from_numpy(r["y"]), flat,
        init_opt_state(M, C, flat.shape[1], "cpu", r["optimizer"]),
        *r["draws"], torch.from_numpy(r["tw"]).sum(-1), hidden=H,
        batch_size=r["B"], lr=LR, wd=WD, lr_scale=0.5,
        feat_mask=torch.from_numpy(r["fm"]), optimizer=r["optimizer"])
    _newp, jopt, jclient, jn, jloss, _stats, _ = r["out"]
    atol = ATOL if r["optimizer"] == "sgd" else ADAM_PARAM_ATOL
    np.testing.assert_allclose(client, _pack(jclient, F, K), atol=atol,
                               rtol=0)
    assert np.array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(loss, np.asarray(jloss), atol=ATOL, rtol=0)
    if r["optimizer"] == "sgd":
        assert opt == {}
    else:
        st = jopt[1][0]
        np.testing.assert_allclose(opt["mu"], _pack(st.mu, F, K), atol=ATOL,
                                   rtol=0)
        for k, v in (("nu", st.nu), ("nu_max", st.nu_max)):
            np.testing.assert_allclose(opt[k], _pack(v, F, K), atol=1e-9,
                                       rtol=NU_RTOL)
        assert np.array_equal(opt["count"].numpy(), np.asarray(st.count))
    assert n[1, 2] == 0 and torch.equal(client[1, 2], flat[1])


def test_train_round_matches_reference(jax_round, monkeypatch):
    """The port's round: K1's plain version, then K2's, with the new
    params and aggregation stats; at N = B = FUSED_ROWS through the fused
    route's one call (``local_sgd_fedavg``, K2 as K1's epilogue), else K1
    and K2 each called."""
    from feddrift_torch.core import step as step_module
    r = jax_round
    F, K = r["F"], r["K"]
    mod = FeedForwardNN((F,), K, H)
    step = TrainStep(mod, r["B"], S, K, lr=LR, wd=WD,
                     optimizer=r["optimizer"], device="cpu")
    calls = []
    for name in ("local_sgd_fedavg", "local_sgd"):
        fn = getattr(step_module, name)
        monkeypatch.setattr(step_module, name, lambda *a, _n=name, _f=fn,
                            **kw: calls.append(_n) or _f(*a, **kw))
    params = params_from_jax(r["jp"], "cpu")
    newp, _opt, client, n, losses, stats = step.train_round(
        params, step.init_opt_states(params, M, C), torch.from_numpy(r["x"]),
        torch.from_numpy(r["y"]), torch.from_numpy(r["tw"]), 0.5,
        feat_mask=torch.from_numpy(r["fm"]), draws=r["draws"],
        with_agg_stats=True)
    assert calls == ["local_sgd_fedavg" if r["N"] == FUSED_ROWS
                     else "local_sgd"]
    jnewp, _, jclient, jn, jloss, jstats, _ = r["out"]
    atol = ATOL if r["optimizer"] == "sgd" else ADAM_PARAM_ATOL
    np.testing.assert_allclose(mod.pack(newp), _pack(jnewp, F, K), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(mod.pack(client), _pack(jclient, F, K),
                               atol=atol, rtol=0)
    assert np.array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(losses, np.asarray(jloss), atol=ATOL, rtol=0)
    assert np.array_equal(stats.numpy(), np.asarray(jstats))


@pytest.mark.parametrize("dataset", ["susy", "stackoverflow_lr"])
@pytest.mark.parametrize("masked", [False, True])
def test_eval_matches_reference(dataset, masked):
    """Correct counts and NLL sums per (model, client, step) of a two-step
    window against the reference's ``acc_matrix``."""
    import jax.numpy as jnp
    _, F, K = WIDTHS[dataset]
    jm, jp = _jax_pool(7, F, K)
    jstep = _jax_step(jm, "adam", K)
    flat = _pack(jp, F, K)
    x, y = _data(dataset, 8)
    fm = np.ones((M, F), np.float32)
    if masked:
        fm[1, ::3] = 0.0
    correct, nll = eval_cells(flat, torch.from_numpy(x[:, 1:3]),
                              torch.from_numpy(y[:, 1:3]), hidden=H,
                              feat_mask=torch.from_numpy(fm))
    for g in range(2):
        wc, wl, _ = jstep.acc_matrix(jp, jnp.asarray(x[:, 1 + g]),
                                     jnp.asarray(y[:, 1 + g]),
                                     jnp.asarray(fm))
        assert np.array_equal(correct[..., g].numpy(), np.asarray(wc))
        np.testing.assert_allclose(nll[..., g].numpy(), np.asarray(wl),
                                   rtol=NLL_RTOL, atol=0)


# --------------------------------------------------------------------------
# The slice: a short run against the reference's

@pytest.mark.parametrize("dataset,algo,rows", [
    pytest.param("susy", "softcluster", 40, id="susy-softcluster"),
    pytest.param("susy", "win-1", 40, id="susy-win-1"),
    pytest.param("ro", "softcluster", 40, id="ro-softcluster"),
    pytest.param("stackoverflow_lr", "softcluster", 40,
                 id="stackoverflow_lr-softcluster"),
    pytest.param("susy", "softcluster", FUSED_ROWS,
                 id="susy-softcluster-fused"),
    pytest.param("susy", "win-1", FUSED_ROWS, id="susy-win-1-fused"),
    pytest.param("ro", "softcluster", FUSED_ROWS,
                 id="ro-softcluster-fused")])
def test_run_tracks_the_reference(dataset, algo, rows, monkeypatch):
    """The dataset through ``Experiment`` in both packages from the
    reference's initial pool, 4 clients, N = B = ``rows``, T = 2, R = 10:
    step 0's logged evals agree (the same batches); step 1's draws differ,
    so only its shape and finiteness are held. At 40 rows the rounds take
    the general route (K1, then K2, every eval its own K3 call); at
    FUSED_ROWS susy and ro take the fused one, each eval but a step's last
    folded into the next round's K1 call."""
    import jax

    from feddrift_torch.core import step as step_module
    from feddrift_torch.kernels.local_sgd import _folds_eval
    from feddrift_torch.simulation.runner import Experiment
    from feddrift_tpu.simulation.runner import Experiment as JExp
    small = dict(dataset=dataset, concept_drift_algo=algo,
                 client_num_in_total=4, client_num_per_round=4,
                 sample_num=rows, batch_size=rows, train_iterations=2,
                 comm_round=10, frequency_of_the_test=5)
    fused = rows == FUSED_ROWS
    _, F, K = WIDTHS[dataset] if dataset in WIDTHS else (None, None, None)
    if F is not None:
        assert _folds_eval(F, H, K, rows, rows) is fused
    folded = []
    fn = step_module.local_sgd_fedavg
    monkeypatch.setattr(
        step_module, "local_sgd_fedavg",
        lambda *a, **kw: folded.append(kw.get("eval_window") is not None)
        or fn(*a, **kw))
    if dataset == "stackoverflow_lr":
        small.update(SMALL_SO)
    jexp = JExp(JaxConfig(**small))
    init = jax.tree_util.tree_map(np.asarray, jexp.pool.params)
    jexp.run()
    exp = Experiment(TorchConfig(**small), device="cpu")
    exp.pool.params = params_from_jax(init, "cpu")
    exp.run()
    ours, ref = exp.logger.history, jexp.logger.history
    assert len(ours) == len(ref) == 2 * 3
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        assert (a["iteration"], a["round"]) == (b["iteration"], b["round"])
    for a, b in zip(ours[:3], ref[:3]):           # step 0: the same batches
        for k in a:
            if "Acc" in k:
                assert a[k] == pytest.approx(b[k], abs=ACC_ATOL), k
            elif "Loss" in k:
                assert a[k] == pytest.approx(b[k], abs=LOSS_ATOL), k
            elif k != "_ts":
                assert a[k] == b[k], k
    assert all(np.isfinite(v) for r in ours for k, v in r.items()
               if "/" in k)
    # a step's R = 10 rounds evaluate after rounds 0, 5 and 9: the first
    # two in the next round's K1 call on the fused route
    assert len(folded) == (2 * 10 if fused else 0)
    assert sum(folded) == (2 * 2 if fused else 0)


# --------------------------------------------------------------------------
# What train_tabular runs on the card

@pytest.mark.parametrize("dataset", ["susy", "ro", "stackoverflow_lr"])
def test_reference_init_is_the_reference_pools(dataset):
    """train_tabular's initial params are what the JAX package's runner
    puts in every slot of the dataset's fnn pool at seed 0
    (ModelPool.create with seed 42), bitwise, packed in param_specs
    order."""
    import jax

    from feddrift_tpu.simulation.runner import Experiment as JaxExperiment
    exp = JaxExperiment(JaxConfig(dataset=dataset, train_iterations=1,
                                  sample_num=10))
    shape, K, _, _ = chip_smoke.NEW_DATASETS[dataset]
    mod = FeedForwardNN(shape, K, H)
    want = mod.pack(params_from_jax(jax.tree_util.tree_map(
        np.asarray, exp.pool.init_params), "cpu"))
    got = np.load(chip_smoke._reference_init(dataset))
    assert got.dtype == np.float32 and got.shape == (mod.num_params,)
    assert np.array_equal(got, want.numpy())
    slots = jax.tree_util.tree_map(np.asarray, exp.pool.params)
    assert np.array_equal(mod.pack(params_from_jax(slots, "cpu"))[-1].numpy(),
                          got)


@pytest.mark.parametrize("dataset", ["susy", "ro", "stackoverflow_lr",
                                     "femnist", "cifar10"])
def test_the_card_runs_are_pinned_and_gated(dataset):
    """Each run of ``TABULAR_RUNS`` / ``IMAGE_RUNS``: 10 steps of R = 200,
    its committed run (where there is one) pinned as committed and named
    as the CLI names it, its gate series a value a step, its tolerances
    at least SEA's; the K1 route ``NEW_DATASETS`` names is ``_route``'s at
    the dataset's width and batch."""
    from feddrift_torch.kernels.local_sgd import _route
    runs = {**chip_smoke.TABULAR_RUNS, **chip_smoke.IMAGE_RUNS}[dataset]
    shape, K, route, _ = chip_smoke.NEW_DATASETS[dataset]
    assert _route(int(np.prod(shape)), H, K, 500, "adam") == route
    for algo, arg, pool, steps, run, pinned, step_tol, mean_tol in runs:
        assert steps == 10 and pool == 4
        assert step_tol >= chip_smoke.STEP_ACC_TOL
        assert mean_tol >= chip_smoke.MEAN_ACC_TOL
        ref = chip_smoke.NEW_REFERENCE_ACCS.get(dataset, {}).get(algo)
        if run is not None:
            assert run == f"{dataset}-fnn-{algo}-{arg}-s0"
            path = f"{chip_smoke.os.path.dirname(chip_smoke.__file__)}/runs/" \
                f"{run}/metrics.jsonl"
            assert chip_smoke._reference_accs(path, pinned) == list(pinned)
        else:
            assert ref is not None
        gate = ref if ref is not None else pinned
        assert len(gate) == 10 and all(0.0 < a <= 1.0 for a in gate)
