"""FMoW, the paper's fifth dataset, in the port against the JAX package on
the CPU: its data (``data/fmow.py``), K1's and K3's plain versions at a
narrow fmow width, a short run through ``Experiment``, the reference's
init that ``chip_smoke.py``'s ``train_fmow`` starts from, and the committed
runs it holds the card to.

Both packages draw from numpy ``default_rng`` in the same order, so the
arrays are compared bitwise, at image sizes 8 and 32. The narrow width is
8 x 8 x 3 images (F = 192) with fmow's fnn otherwise (H 10, K 62); the
round runs on the reference's own batch draws (its fold_in key path,
reproduced here).

Tolerances (float32), as ``tests/test_torch_lr_sgd.py`` states them for
MNIST's width: after a round losses, mu and (SGD) params at atol 2e-6, nu
and nu_max at rtol 1e-4, AMSGrad's params at atol 2e-5 (its first step
moves a parameter by lr * g / (|g| + eps), so a gradient whose rows nearly
cancel moves by up to ~lr * 2e-4 under another summation order); n
exactly. The eval: counts exactly, NLL sums at rtol 1e-5. A run: step 0
trains on the same batches in both packages (N = B), so its logged evals
agree to 1e-4 on accuracies and 1e-3 on losses.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from feddrift_torch.config import ExperimentConfig as TorchConfig
from feddrift_torch.convert import params_from_jax
from feddrift_torch.core.step import TrainStep
from feddrift_torch.data import fmow as tfmow
from feddrift_torch.data.registry import available_datasets
from feddrift_torch.data.registry import make_dataset as torch_make
from feddrift_torch.kernels.eval_cells import eval_cells
from feddrift_torch.kernels.local_sgd import init_opt_state, local_sgd_ref
from feddrift_torch.models.mlp import FeedForwardNN
from feddrift_tpu.config import ExperimentConfig as JaxConfig
from feddrift_tpu.data import fmow as jfmow
from feddrift_tpu.data.registry import make_dataset as jax_make
from torch_threads import one_intra_op_thread  # noqa: F401

M, C, T, N, B, S = 2, 3, 2, 40, 20, 3
SIDE, H, K = 8, 10, 62
F = SIDE * SIDE * 3
LR, WD = 0.05, 0.001
ATOL, ADAM_PARAM_ATOL, NU_RTOL, NLL_RTOL = 2e-6, 2e-5, 1e-4, 1e-5
ACC_ATOL, LOSS_ATOL = 1e-4, 1e-3


def _same(got, want):
    assert got.x.dtype == np.float32 and got.y.dtype == np.int32
    assert np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)
    assert np.array_equal(got.concepts, want.concepts)
    assert got.num_classes == want.num_classes == 62
    assert got.meta == want.meta and got.name == want.name == "fmow"


# --------------------------------------------------------------------------
# The data

@pytest.mark.parametrize("size", [8, 32])
@pytest.mark.parametrize("dataset,noise,seed", [
    ("fmow", 0.0, 0), ("fmow", 0.1, 3), ("fmow-smooth", 0.0, 1),
    ("fmow-smooth", 0.05, 2)])
def test_dataset_bitwise_equals_reference(dataset, noise, seed, size):
    kw = dict(dataset=dataset, fmow_image_size=size, train_iterations=2,
              sample_num=20, noise_prob=noise, seed=seed)
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert got.x.shape == (10, 3, 20, size, size, 3)
    _same(got, want)


def test_registry_and_defaults():
    assert {"fmow", "fmow-smooth"} <= set(available_datasets())
    assert TorchConfig().fmow_image_size == JaxConfig().fmow_image_size == 32
    assert tfmow.NUM_CLASSES == jfmow.NUM_CLASSES


def _write_partitions(root, size, n=12, channels=4, skip=None):
    """``client_{c}_iter_{t}.npz`` for 10 clients and 3 steps under
    ``root/fmow/partitions/A``, with ``n`` rows of ``size`` x ``size``
    images of ``channels`` channels (the reader keeps 3)."""
    part = root / "fmow" / "partitions" / "A"
    part.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for c in range(10):
        for t in range(3):
            if (c, t) == skip:
                continue
            np.savez(part / f"client_{c}_iter_{t}.npz",
                     x=rng.normal(size=(n, size, size, channels))
                     .astype(np.float32),
                     y=rng.integers(0, 62, n).astype(np.int32))


@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_partitions_are_read_verbatim(tmp_path, noise):
    """Real partitions are used as the reference uses them: short ones
    wrap, the fourth channel goes, label noise applies; -smooth ignores
    them."""
    _write_partitions(tmp_path, 8)
    kw = dict(dataset="fmow", fmow_image_size=8, train_iterations=2,
              sample_num=20, noise_prob=noise, data_dir=str(tmp_path))
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert got.meta == {"real_data": True}
    _same(got, want)
    d = np.load(tmp_path / "fmow" / "partitions" / "A" / "client_0_iter_0.npz")
    assert np.array_equal(got.x[0, 0, 12:], d["x"][:8, ..., :3])
    smooth = dict(kw, dataset="fmow-smooth")
    got = torch_make(TorchConfig(**smooth))
    assert got.meta["real_data"] is False
    _same(got, jax_make(JaxConfig(**smooth)))


def test_partitions_of_another_size_are_refused(tmp_path):
    _write_partitions(tmp_path, 16)
    kw = dict(dataset="fmow", fmow_image_size=8, train_iterations=2,
              sample_num=20, data_dir=str(tmp_path))
    for make, cfg in ((torch_make, TorchConfig), (jax_make, JaxConfig)):
        with pytest.raises(ValueError, match="partition images are"):
            make(cfg(**kw))


def test_incomplete_partitions_fall_back_to_synthetic(tmp_path):
    _write_partitions(tmp_path, 8, skip=(9, 2))
    kw = dict(dataset="fmow", fmow_image_size=8, train_iterations=2,
              sample_num=20, data_dir=str(tmp_path))
    got = torch_make(TorchConfig(**kw))
    assert got.meta == {"real_data": False}
    _same(got, jax_make(JaxConfig(**kw)))


# --------------------------------------------------------------------------
# K1 and K3's plain versions at a narrow fmow width, on the reference's draws

def _data(seed):
    """A narrow fmow window: images of the synthetic data, laid out
    ``[C, T1, N, F]`` (flattened over H, W, C, as the fnn flattens them)."""
    ds = jax_make(JaxConfig(dataset="fmow", fmow_image_size=SIDE,
                            train_iterations=T, sample_num=N, seed=seed))
    x = ds.x[:C].reshape(C, T + 1, N, F)
    return np.ascontiguousarray(x), np.ascontiguousarray(ds.y[:C])


def _time_w(seed):
    rng = np.random.default_rng(seed + 100)
    tw = (rng.random((M, C, T + 1)) < 0.6).astype(np.float32)
    tw[:, :, T] = 0.0                      # the test step never trains
    tw[1, 2, :] = 0.0                      # an inactive pair
    tw[0, 0, :T] = 1.0
    return tw


def _jax_pool(seed):
    import jax
    import jax.numpy as jnp

    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    jm = JFnn(num_classes=K, hidden_dim=H)
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    jp = jax.vmap(lambda k: jm.init(k, jnp.zeros((1, F)))["params"])(keys)
    return jm, jax.tree_util.tree_map(np.asarray, jp)


def _jax_step(jm, optimizer):
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    return JStep(lambda p, x: jm.apply({"params": p}, x),
                 make_optimizer(optimizer, LR, WD), B, S, K)


def _pack(tree):
    import jax
    return FeedForwardNN((F,), K, H).pack(params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), "cpu"))


def _jax_draws(key, time_w):
    """The reference's batch indices of one round, [M, C, S] each."""
    import jax
    import jax.numpy as jnp
    keys = jax.random.split(key, M * C).reshape(M, C, 2)

    def pair(k, w):
        w_safe = jnp.where(w.sum() > 0, w, jnp.ones_like(w))
        logits = jnp.log(w_safe + 1e-30)

        def one(kk):
            k1, k2 = jax.random.split(kk)
            return (jax.random.categorical(k1, logits),
                    jax.random.randint(k2, (), 0, N // B))
        return jax.vmap(one)(jax.random.split(k, S))
    t_idx, slot = jax.vmap(jax.vmap(pair))(keys, jnp.asarray(time_w))
    return (torch.from_numpy(np.array(t_idx, np.int32)),
            torch.from_numpy(np.array(slot, np.int32)))


@pytest.fixture(scope="module", params=["adam", "sgd"])
def jax_round(request):
    """One reference train_round at the narrow fmow width, with its draws
    and masks (model 1 off on every third input)."""
    import jax
    import jax.numpy as jnp
    optimizer = request.param
    seed = 1 if optimizer == "adam" else 2
    x, y = _data(seed)
    tw = _time_w(seed)
    fm = np.ones((M, F), np.float32)
    fm[1, ::3] = 0.0
    jm, jp = _jax_pool(seed)
    jstep = _jax_step(jm, optimizer)
    key = jax.random.PRNGKey(30 + seed)
    out = jstep.train_round(
        jp, jstep.init_opt_states(jp, M, C), key, jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(tw), jnp.ones((M, C, N)), jnp.asarray(fm),
        jnp.float32(0.5), with_agg_stats=True)
    return dict(optimizer=optimizer, x=x, y=y, tw=tw, fm=fm, jp=jp, out=out,
                draws=_jax_draws(key, tw))


def test_local_sgd_ref_matches_reference(jax_round):
    """Client params, optimizer state, n and loss of every pair against
    ``_local_sgd`` at fmow's fnn (F 192, H 10, K 62), with feature masks
    and lr_scale 0.5."""
    r = jax_round
    flat = _pack(r["jp"])
    client, opt, n, loss = local_sgd_ref(
        torch.from_numpy(r["x"]), torch.from_numpy(r["y"]), flat,
        init_opt_state(M, C, flat.shape[1], "cpu", r["optimizer"]),
        *r["draws"], torch.from_numpy(r["tw"]).sum(-1), hidden=H,
        batch_size=B, lr=LR, wd=WD, lr_scale=0.5,
        feat_mask=torch.from_numpy(r["fm"]), optimizer=r["optimizer"])
    _newp, jopt, jclient, jn, jloss, _stats, _ = r["out"]
    atol = ATOL if r["optimizer"] == "sgd" else ADAM_PARAM_ATOL
    np.testing.assert_allclose(client, _pack(jclient), atol=atol, rtol=0)
    assert np.array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(loss, np.asarray(jloss), atol=ATOL, rtol=0)
    if r["optimizer"] == "sgd":
        assert opt == {}
    else:
        st = jopt[1][0]
        np.testing.assert_allclose(opt["mu"], _pack(st.mu), atol=ATOL,
                                   rtol=0)
        for k, v in (("nu", st.nu), ("nu_max", st.nu_max)):
            np.testing.assert_allclose(opt[k], _pack(v), atol=1e-9,
                                       rtol=NU_RTOL)
        assert np.array_equal(opt["count"].numpy(), np.asarray(st.count))
    assert n[1, 2] == 0 and torch.equal(client[1, 2], flat[1])


def test_train_round_matches_reference(jax_round):
    """The port's round on image-shaped x ([C, T1, N, 8, 8, 3], flattened
    in ``_round_body``) and feature masks of that shape: K1's plain
    version, then K2's, with the new params and aggregation stats."""
    r = jax_round
    mod = FeedForwardNN((SIDE, SIDE, 3), K, H)
    step = TrainStep(mod, B, S, K, lr=LR, wd=WD, optimizer=r["optimizer"],
                     device="cpu")
    params = params_from_jax(r["jp"], "cpu")
    x = torch.from_numpy(r["x"]).reshape(C, T + 1, N, SIDE, SIDE, 3)
    fm = torch.from_numpy(r["fm"]).reshape(M, SIDE, SIDE, 3)
    newp, _opt, client, n, losses, stats = step.train_round(
        params, step.init_opt_states(params, M, C), x,
        torch.from_numpy(r["y"]), torch.from_numpy(r["tw"]), 0.5,
        feat_mask=fm, draws=r["draws"], with_agg_stats=True)
    jnewp, _, jclient, jn, jloss, jstats, _ = r["out"]
    atol = ATOL if r["optimizer"] == "sgd" else ADAM_PARAM_ATOL
    np.testing.assert_allclose(mod.pack(newp), _pack(jnewp), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(mod.pack(client), _pack(jclient), atol=atol,
                               rtol=0)
    assert np.array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(losses, np.asarray(jloss), atol=ATOL, rtol=0)
    assert np.array_equal(stats.numpy(), np.asarray(jstats))


@pytest.mark.parametrize("masked", [False, True])
def test_eval_matches_reference(masked):
    """Correct counts and NLL sums per (model, client, step) of a two-step
    window against the reference's ``acc_matrix`` (``_acc_matrix_body``)
    at the narrow fmow width, 62 classes."""
    import jax.numpy as jnp
    jm, jp = _jax_pool(7)
    jstep = _jax_step(jm, "adam")
    flat = _pack(jp)
    x, y = _data(8)
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

@pytest.mark.parametrize("algo", ["softcluster", "win-1"])
def test_run_tracks_the_reference(algo):
    """fmow at 8 x 8 x 3 through ``Experiment`` in both packages from the
    reference's initial pool, 4 clients, N = B = 40, T = 2, R = 10: step
    0's logged evals agree (the same batches); step 1's draws differ, so
    only its shape and finiteness are held."""
    import jax

    from feddrift_torch.simulation.runner import Experiment
    from feddrift_tpu.simulation.runner import Experiment as JExp
    small = dict(dataset="fmow", fmow_image_size=SIDE,
                 concept_drift_algo=algo, client_num_in_total=4,
                 client_num_per_round=4, sample_num=40, batch_size=40,
                 train_iterations=2, comm_round=10, frequency_of_the_test=5)
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


# --------------------------------------------------------------------------
# What train_fmow runs on the card

def test_fmow_reference_init_is_the_reference_pools():
    """train_fmow's initial params are what the JAX package's runner puts
    in every slot of the fmow fnn pool at seed 0 (ModelPool.create with
    seed 42), bitwise, packed in param_specs order."""
    import jax

    from feddrift_tpu.simulation.runner import Experiment as JaxExperiment
    exp = JaxExperiment(JaxConfig(dataset="fmow", train_iterations=1,
                                  sample_num=10))
    mod = FeedForwardNN((32, 32, 3), 62, 10)
    want = mod.pack(params_from_jax(jax.tree_util.tree_map(
        np.asarray, exp.pool.init_params), "cpu"))
    got = np.load(chip_smoke.FMOW_REFERENCE_INIT)
    assert got.dtype == np.float32 and got.shape == (mod.num_params,)
    assert mod.num_params == 31412
    assert np.array_equal(got, want.numpy())
    slots = jax.tree_util.tree_map(np.asarray, exp.pool.params)
    assert np.array_equal(mod.pack(params_from_jax(slots, "cpu"))[-1].numpy(),
                          got)


@pytest.mark.parametrize("run", chip_smoke.FMOW_RUNS, ids=lambda r: r[4])
def test_fmow_reference_runs_are_the_committed_ones(run):
    """train_fmow's committed runs: R = 200, T = 10, one run a file, named
    as the CLI names it, pinned as committed; each run is gated a step and
    on the mean against the JAX package's run from the same init, whose
    series starts where every committed run's step 0 sits, near chance."""
    import json

    from feddrift_torch.cli import run_dir
    algo, arg, pool, T, name, pinned, step_tol, mean_tol = run
    metrics = os.path.join(os.path.dirname(chip_smoke.REF_RUN), "..", name,
                           "metrics.jsonl")
    assert chip_smoke._reference_accs(metrics, pinned) == list(pinned)
    rows = [json.loads(ln) for ln in open(metrics)]
    assert rows[-1]["round"] == 1999 and rows[-1]["iteration"] == 9
    assert name == f"fmow-fnn-{algo}-{arg}-s0" and T == 10 and pool == 4
    assert run_dir(TorchConfig(
        dataset="fmow", concept_drift_algo=algo, concept_drift_algo_arg=arg,
        concept_num=pool, out_dir="runs")) == os.path.join("runs", name)
    assert mean_tol >= chip_smoke.MEAN_ACC_TOL
    assert step_tol >= chip_smoke.STEP_ACC_TOL
    ref = chip_smoke.FMOW_REFERENCE_ACCS[algo]
    assert len(ref) == T and ref[0] == 0.0164
    assert round(abs(ref[0] - pinned[0]), 6) <= 0.0012
    assert set(chip_smoke.FMOW_REFERENCE_ACCS) == {
        r[0] for r in chip_smoke.FMOW_RUNS}


def test_fmow_runs_take_the_split_and_stream_routes():
    """Every fmow run's shape takes K1's split kernel and K3's wide route
    on its streamed kernel (64-row tiles; the route took 16-row tiles
    before): the routes train_fmow holds the card to."""
    import importlib
    k1 = importlib.import_module("feddrift_torch.kernels.local_sgd")
    k3 = importlib.import_module("feddrift_torch.kernels.eval_cells")
    for run in chip_smoke.FMOW_RUNS:
        cfg = TorchConfig(dataset="fmow", concept_drift_algo=run[0],
                          concept_drift_algo_arg=run[1])
        assert k1._route(3072, cfg.fnn_hidden_dim, 62,
                         min(cfg.batch_size, cfg.sample_num),
                         cfg.client_optimizer) == "split"
    assert k3._route(3072, 10, 62) == "wide"
    assert k3.wide_rows(3072, 10, 62) == k3.STREAM_ROWS
