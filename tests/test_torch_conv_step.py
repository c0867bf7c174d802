"""The conv models' round and evals (``TrainStep``'s model-generic path:
``core/functional.py::model_local_sgd`` and ``model_logits``, then K2's
plain version on the CPU) against the JAX package's ``TrainStep`` on the
CPU, for ``cnn`` and ``resnet8``.

Both packages get the same seeded numpy data (8 x 8 x 3 images, 5 classes)
and the same parameters (the port's init, carried into the reference's
tree); the reference's batch draws (its ``split(key, M·C)`` keys, turned
into indices as its ``_local_sgd`` does) are injected into the port.
Tolerances: after a round of S = 2 AMSGrad steps (lr 0.01) the params, the
client stack and mu within 1e-6 absolute, nu and nu_max within 1e-4
relative (squares of gradients that differ by float32 sums in other
orders, ~1e-6 relative; and within 1e-4 of the largest, where a gradient
is a cancellation's rounding), the losses within 1e-5, n and the aggregation
stats exactly. A ReLU input or a max pool's window that ties to rounding
sends a unit's gradient another way in the other package, and AMSGrad's
normalised step turns that into up to lr a step: at most one element in
FLIP_FRAC (1e-3) of each may leave its tolerance (~2e-4 of them did), and
no param further than S·lr·(1 + 1e-3) + wd, the most S steps move one; the eval matrices' counts within one row (a row on a
decision boundary may flip), their NLL and Brier sums within 1e-4
relative, the ensemble's counts within one row and confusion matrices
within one row a model and client.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from feddrift_torch.core.step import TrainStep
from feddrift_torch.models.cnn import CNNFedAvg
from feddrift_torch.models.resnet import ResNetCifar
from test_torch_statebased import _reference_draws
from test_torch_train_step import _opt_to_port, _pack

M, C, T, N, B, S, K, LR, WD = 2, 3, 2, 16, 8, 2, 5, 0.01, 0.001
IMAGE = (8, 8, 3)
ATOL, NU_RTOL, LOSS_ATOL, NLL_RTOL = 1e-6, 1e-4, 1e-5, 1e-4
FLIP_FRAC = 1e-3
STEP_BOUND = S * LR * (1 + 1e-3) + WD
MODELS = {"cnn": lambda: CNNFedAvg(IMAGE, K),
          "resnet8": lambda: ResNetCifar(IMAGE, K, depth=8)}


def _jax_module(name):
    from feddrift_tpu.models.cnn import CNNFedAvg as JC
    from feddrift_tpu.models.resnet import ResNetCifar as JR
    return JC(K) if name == "cnn" else JR(K, 8)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (C, T + 1, N, *IMAGE)).astype(np.float32)
    y = ((x[..., 0].mean((-1, -2)) * 3 * K) % K).astype(np.int32)
    return x, y


def _time_w():
    tw = np.ones((M, C, T + 1), np.float32)
    tw[:, :, T] = 0.0                      # the test step never trains
    tw[1, 2, :] = 0.0                      # an inactive pair
    tw[0, 1, 0] = 0.0
    return tw


def _setup(name, seed=0):
    """The port's module, pool params [M, ...] (distinct per model) and the
    reference's step and the same params as its tree."""
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    mod = MODELS[name]()
    gen = torch.Generator().manual_seed(seed)
    draws = [mod.init_params(gen, "cpu") for _ in range(M)]
    params = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v.numpy())
                           for k, v in params.items()})
    jm = _jax_module(name)
    jstep = JStep(lambda p, x: jm.apply({"params": p}, x),
                  make_optimizer("adam", LR, WD), B, S, K)
    return mod, params, jstep, tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, atol=ATOL, rtol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


def _close_but_flips(a, b, atol=ATOL, rtol=0.0, bound=None):
    """Within ``atol + rtol·|b|`` but for at most FLIP_FRAC of the
    elements, and every element within ``bound`` (None: no bound)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    d = np.abs(a - b)
    out = d > atol + rtol * np.abs(b)
    assert out.mean() <= FLIP_FRAC, (int(out.sum()), out.size, d.max())
    if bound is not None:
        assert d.max() <= bound, d.max()


def _round_both(name, optimizer="adam", weighted=False, masked=False):
    """One round of ``name`` in both packages on the same data, params and
    draws: the reference's ``train_round`` and the port's, the port fed the
    reference's draws (its uniforms where ``weighted``: KUE's Poisson
    sample weights, searched by K4's plain version). ``masked``: a 0/1
    feature mask a model (one channel off in model 0, a column of pixels
    in model 1). Returns the port's module, params, outputs and the
    reference's outputs."""
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    x, y = _data()
    tw = _time_w()
    mod, params, _, tree = _setup(name)
    jm = _jax_module(name)
    jstep = JStep(lambda p, x: jm.apply({"params": p}, x),
                  make_optimizer(optimizer, LR, WD), B, S, K,
                  weighted_sampling=weighted)
    rng = np.random.default_rng(5)
    sw = rng.poisson(1.0, (M, C, N)).astype(np.float32) if weighted \
        else np.ones((M, C, N), np.float32)
    fm = np.ones((M, *IMAGE), np.float32)
    if masked:
        fm[0, :, :, 1] = 0.0
        fm[1, :, 3, :] = 0.0
    key = jax.random.PRNGKey(7)
    jout = jstep.train_round(
        tree, jstep.init_opt_states(tree, M, C), key, jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(tw), jnp.asarray(sw), jnp.asarray(fm),
        jnp.float32(1.0), with_agg_stats=True)
    step = TrainStep(mod, B, S, K, lr=LR, wd=WD, optimizer=optimizer,
                     device="cpu", weighted_sampling=weighted)
    assert step.conv
    out = step.train_round(
        params, step.init_opt_states(params, M, C), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(tw),
        sample_w=torch.from_numpy(sw) if weighted else None,
        feat_mask=torch.from_numpy(fm) if masked else None,
        draws=_reference_draws(key, tw, S, B, N, weighted),
        with_agg_stats=True)
    return mod, params, out, jout


def _check_round(mod, params, out, jout, optimizer="adam"):
    newp, opt, client, n, losses, stats = out
    jnewp, jo, jclient, jn, jloss, jstats, _ = jout
    if optimizer == "adam":
        _close_but_flips(mod.pack(newp), _pack(mod, jnewp), bound=STEP_BOUND)
        _close_but_flips(mod.pack(client), _pack(mod, jclient),
                         bound=STEP_BOUND)
        want = _opt_to_port(mod, jo)
        _close_but_flips(opt["mu"], want["mu"])
        for k in ("nu", "nu_max"):
            _close_but_flips(opt[k], want[k], rtol=NU_RTOL,
                             atol=NU_RTOL * float(want[k].abs().max()))
        assert torch.equal(opt["count"], want["count"])
        assert int(opt["count"][1, 2]) == 0
    else:                      # SGD's step is the gradient's: no flips
        _close(mod.pack(newp), _pack(mod, jnewp))
        _close(mod.pack(client), _pack(mod, jclient))
        assert opt == {}                      # optax.sgd keeps no state
    _close(n, jn, atol=0)
    _close(losses, jloss, atol=LOSS_ATOL)
    _close(stats, jstats, atol=0)
    # the inactive pair kept the pool's params (and a fresh state)
    assert torch.equal(mod.pack(client)[1, 2], mod.pack(params)[1])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_round_matches_reference(name):
    _check_round(*_round_both(name))


@pytest.mark.parametrize("name, optimizer, weighted, masked", [
    ("cnn", "adam", True, True), ("cnn", "sgd", True, True),
    ("resnet8", "sgd", True, True), ("resnet8", "sgd", False, True)],
    ids=["cnn-adam_weighted_masked", "cnn-sgd_weighted_masked",
         "resnet8-sgd_weighted_masked", "resnet8-sgd_masked"])
def test_round_variants_match_reference(name, optimizer, weighted, masked):
    """The round's other paths a user selects, against the reference's:
    KUE's weighted draw (its uniforms, K4's rows), feature masks, and plain
    SGD (``--client_optimizer sgd``). Under SGD the params match within
    ATOL with no flip allowed. AMSGrad's first steps are near sign(g) for
    every parameter, so a gradient at rounding level in both packages
    moves its parameter by up to lr in either: resnet8's batch norms leave
    ~2 % of its parameters so under a mask or the weighted rows, beyond
    FLIP_FRAC, while SGD holds the same round to 1.2e-7. So AMSGrad's
    variant runs on the cnn, and resnet8's on SGD: the draw and the mask
    are the same code under either optimizer."""
    mod, params, out, jout = _round_both(name, optimizer, weighted, masked)
    _check_round(mod, params, out, jout, optimizer)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_matrices_match_reference(name):
    """``acc_matrix`` (the K3 cells: each (model, client)'s count and NLL
    sum over the step's N rows, a batch norm over those rows),
    ``acc_window`` (the train and test steps of an eval at once),
    ``acc_cells``, ``mse_matrix``, ``confusion_matrices`` and
    ``ensemble_eval`` (AUE's hard vote, KUE's soft one) against the
    reference's programs, with a feature mask on the hard vote."""
    x, y = _data(1)
    mod, params, jstep, tree = _setup(name, seed=2)
    step = TrainStep(mod, B, S, K, device="cpu")
    ones = jnp.ones((M, *IMAGE))
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
    wc, wl, _ = step.acc_window(params, xt[:, 1:3], yt[:, 1:3])
    counts(wc[..., 0], correct)           # the window's groups batch apart
    _close(wl[..., 0], nll, atol=0, rtol=NLL_RTOL)
    counts(step.acc_cells(params, xt, yt),
           jstep.acc_cells(tree, jx, jy, ones))
    mse, _ = step.mse_matrix(params, xt[:, 0], yt[:, 0])
    _close(mse, jstep.mse_matrix(tree, jx[:, 0], jy[:, 0], ones)[0], atol=0,
           rtol=NLL_RTOL)
    conf = step.confusion_matrices(params, xt[:, 0], yt[:, 0])
    jconf = np.asarray(jstep.confusion_matrices(tree, jx[:, 0], jy[:, 0],
                                                ones))
    assert conf.shape == (M, C, K, K)
    assert np.abs(conf.numpy() - jconf).sum((-1, -2)).max() <= 2
    mask = np.ones((M, *IMAGE), np.float32)
    mask[0, :, :, 1] = 0.0
    w = np.array([0.7, 0.3], np.float32)
    for mode, fm in (("hard", mask), ("soft", None)):
        got = step.ensemble_eval(
            params, xt[:, 2], yt[:, 2], torch.from_numpy(w), mode,
            feat_mask=None if fm is None else torch.from_numpy(fm))
        want = jstep.ensemble_eval(tree, jx[:, 2], jy[:, 2], jnp.asarray(w),
                                   mode, None,
                                   None if fm is None else jnp.asarray(fm))
        counts(got[0], want[0])
        _close(got[2], want[2], atol=0, rtol=NLL_RTOL)
