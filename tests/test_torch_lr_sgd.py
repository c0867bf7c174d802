"""The ``lr`` model and the ``sgd`` client optimizer, and the fnn at MNIST's
width: the port's model, K1's and K3's plain versions, the round and the
run against the JAX package on the CPU, and the kernels' new routes
against their plain versions on the card (``gpu``).

Both packages get the same seeded numpy data and parameters (flax's,
carried across with ``params_from_jax``); the rounds run on the
reference's own batch draws (its fold_in key path, reproduced here), at
F = 784 (MNIST's width) with small M, C, T and N.

Tolerances (float32). Model outputs at atol 1e-6 (a 784-term dot product
summed in another order, then a sigmoid, whose slope is at most 1/4); with
the weights scaled by s the dot product's rounding grows with s, so at
atol 1e-6 * s / 4 past s = 4. Gradients at atol 1e-6. After a
round: losses and AMSGrad's mu at atol 2e-6; nu and nu_max at rtol 1e-4
(squares of gradients); under SGD the params at atol 2e-6 (an update is lr
times a gradient of ~1e-2, summed over 20-40 rows in another order);
under AMSGrad the params at atol 2e-5: its first step moves a parameter by
lr * g / (|g| + eps), so where a gradient's rows nearly cancel (a few of
the 7850-7960 parameters at F = 784) the rounding of g in another order
moves the update by up to ~lr * 2e-4 (measured: 9.4e-6 at lr 0.05); n
exactly. The eval: counts exactly (ties, saturated sigmoids included),
NLL sums at rtol 1e-5. A run: step 0 trains on the same batches in both
packages (N = B, one batch a step), so its logged evals agree to 1e-4 on
accuracies and 1e-3 on losses, as ``test_torch_runner.py``'s.

JAX is imported inside the CPU tests, so the ``gpu`` tests run on the card
with ``python -m pytest --noconftest -m gpu tests/test_torch_lr_sgd.py``.
"""

import numpy as np
import pytest
import torch

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.convert import params_from_jax
from feddrift_torch.core.step import TrainStep
from feddrift_torch.kernels.eval_cells import _route as eval_route
from feddrift_torch.kernels.eval_cells import _unpack, eval_cells, eval_cells_ref
from feddrift_torch.kernels.local_sgd import (_folds_eval, _route,
                                              init_opt_state, local_sgd,
                                              local_sgd_ref, sgd_step)
from feddrift_torch.models import create_model
from feddrift_torch.models.mlp import FeedForwardNN, LogisticRegression
from torch_threads import one_intra_op_thread  # noqa: F401

M, C, T, N, B, S, F, K, H = 2, 3, 2, 40, 20, 3, 784, 10, 10
LR, WD = 0.05, 0.001
OUT_ATOL = 1e-6
GRAD_ATOL = 1e-6
ATOL = 2e-6
ADAM_PARAM_ATOL = 2e-5
NU_RTOL = 1e-4
NLL_RTOL = 1e-5
ACC_ATOL, LOSS_ATOL = 1e-4, 1e-3


def _data(seed, n=N, c=C, t1=T + 1, f=F, k=K):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 0.8, (c, t1, n, f)).astype(np.float32)
    y = rng.integers(0, k, (c, t1, n)).astype(np.int32)
    return x, y


def _time_w(seed):
    rng = np.random.default_rng(seed + 100)
    tw = (rng.random((M, C, T + 1)) < 0.6).astype(np.float32)
    tw[:, :, T] = 0.0                      # the test step never trains
    tw[1, 2, :] = 0.0                      # an inactive pair
    tw[0, 0, :T] = 1.0
    return tw


def _jax_model(model):
    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    from feddrift_tpu.models.mlp import LogisticRegression as JLr
    return JLr(num_classes=K) if model == "lr" else JFnn(num_classes=K,
                                                         hidden_dim=H)


def _port_model(model):
    return LogisticRegression((F,), K) if model == "lr" \
        else FeedForwardNN((F,), K, H)


def _jax_pool(model, seed, m=M):
    import jax
    import jax.numpy as jnp
    jm = _jax_model(model)
    keys = jax.random.split(jax.random.PRNGKey(seed), m)
    jp = jax.vmap(lambda k: jm.init(k, jnp.zeros((1, F)))["params"])(keys)
    return jm, jax.tree_util.tree_map(np.asarray, jp)


def _jax_step(jm, optimizer, num_steps=S):
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    return JStep(lambda p, x: jm.apply({"params": p}, x),
                 make_optimizer(optimizer, LR, WD), B, num_steps, K)


def _pack(module, tree):
    import jax
    return module.pack(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              tree), "cpu"))


def _jax_draws(key, time_w, nb=N // B):
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
                    jax.random.randint(k2, (), 0, nb))
        return jax.vmap(one)(jax.random.split(k, S))
    t_idx, slot = jax.vmap(jax.vmap(pair))(keys, jnp.asarray(time_w))
    return (torch.from_numpy(np.array(t_idx, np.int32)),
            torch.from_numpy(np.array(slot, np.int32)))


def _close(a, b, atol=ATOL, rtol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


# --------------------------------------------------------------------------
# The model

def test_lr_leaves_and_init_follow_flax():
    import jax
    jm, jp = _jax_pool("lr", 0, m=1)
    mod = create_model("lr", type("D", (), {"feature_shape": (F,),
                                            "num_classes": K})(), None)
    assert isinstance(mod, LogisticRegression) and mod.hidden_dim == 0
    specs = mod.param_specs()
    assert list(specs) == ["Dense_0/kernel", "Dense_0/bias"]
    flat = params_from_jax(jax.tree_util.tree_map(lambda a: a[0], jp), "cpu")
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: s for k, (s, _) in specs.items()}
    assert mod.num_params == F * K + K
    drawn = mod.init_params(torch.Generator().manual_seed(0), "cpu")
    w = drawn["Dense_0/kernel"]
    std = (1.0 / F) ** 0.5
    assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6   # truncated
    assert abs(float(w.std()) - std) < 0.05 * std
    assert torch.equal(drawn["Dense_0/bias"], torch.zeros(K))


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_lr_forward_matches_flax(scale):
    """sigmoid(x W + b) against flax, for one model, a pool against every
    client and per-row weights; ``scale`` 40 saturates most outputs."""
    import jax.numpy as jnp
    jm, jp = _jax_pool("lr", 1, m=2)
    jp = {"Dense_0": {k: v * scale for k, v in jp["Dense_0"].items()}}
    atol = OUT_ATOL * max(1.0, scale / 4)
    mod = LogisticRegression((F,), K)
    params = params_from_jax(jp, "cpu")
    x, _ = _data(2, n=16, c=1, t1=1)
    x = x[0, 0]
    for m in range(2):
        want = jm.apply({"params": {"Dense_0": {k: v[m] for k, v in
                                                jp["Dense_0"].items()}}},
                        jnp.asarray(x))
        got = mod({k: v[m] for k, v in params.items()}, torch.from_numpy(x))
        _close(got, want, atol=atol)
    pool = mod(params, torch.from_numpy(x)[None])          # [M, N, K]
    rows = mod({k: v[torch.tensor([0, 1] * 8)] for k, v in params.items()},
               torch.from_numpy(x))                          # [N, K]
    assert pool.shape == (2, 16, K) and rows.shape == (16, K)
    _close(rows, torch.stack([pool[i % 2, i] for i in range(16)]),
           atol=atol)
    if scale > 1:
        assert int((pool == 1.0).sum()) > 16                # saturated rows


@pytest.mark.parametrize("model", ["lr", "fnn"])
def test_loss_gradient_matches_jax(model):
    """The gradient of the mean cross-entropy of the model's outputs (the
    lr's sigmoid outputs taken as logits) against jax.grad."""
    import jax
    import jax.numpy as jnp
    from feddrift_tpu.core.functional import cross_entropy
    jm, jp = _jax_pool(model, 3, m=1)
    jp1 = jax.tree_util.tree_map(lambda a: a[0], jp)
    x, y = _data(4, n=B, c=1, t1=1)
    x, y = x[0, 0], y[0, 0]
    jgrad = jax.grad(lambda p: cross_entropy(
        jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y)))(jp1)
    mod = _port_model(model)
    flat = mod.pack(params_from_jax(jp1, "cpu")).requires_grad_(True)
    logp = torch.log_softmax(mod(mod.unpack(flat), torch.from_numpy(x)), -1)
    loss = -logp.gather(-1, torch.from_numpy(y).long()[:, None]).mean()
    grad, = torch.autograd.grad(loss, flat)
    _close(grad, _pack(mod, jgrad), atol=GRAD_ATOL)


# --------------------------------------------------------------------------
# SGD and the routes

def test_sgd_step_matches_optax_over_20_steps():
    import jax.numpy as jnp
    from feddrift_tpu.core.step import make_optimizer
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(37).astype(np.float32)
    grads = rng.standard_normal((20, 37)).astype(np.float32)
    opt = make_optimizer("sgd", LR, WD)
    jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    p = torch.from_numpy(p0)
    for g in grads:
        u, js = opt.update(jnp.asarray(g), js, jp)
        jp = jp + u * 0.5
        p = sgd_step(p, torch.from_numpy(g), lr=LR, lr_scale=0.5)
    assert np.array_equal(p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("F_,H_,K_,B_,opt,want", [
    (784, 10, 10, 500, "adam", "wide"),        # MNIST's fnn
    (784, 0, 10, 500, "adam", "wide"),         # MNIST's lr
    (784, 0, 10, 500, "sgd", "wide"),
    (3, 10, 2, 500, "sgd", "general"),         # SEA's fnn under SGD
    (3, 0, 2, 500, "adam", "general"),         # SEA's lr
    (3, 10, 2, 500, "adam", "fused")])
def test_routes_by_shape_model_and_update(F_, H_, K_, B_, opt, want):
    assert _route(F_, H_, K_, B_, opt) == want
    assert _folds_eval(F_, H_, K_, B_, B_, opt) == (want == "fused")
    assert eval_route(F_, H_, K_) == ("fused" if H_ == 10 and K_ == 2
                                      else "wide" if F_ == 784
                                      else "general")


def test_sgd_state_is_empty_and_checked():
    assert init_opt_state(2, 3, 7, "cpu", "sgd") == {}
    step = TrainStep(LogisticRegression((F,), K), B, S, K, optimizer="sgd",
                     device="cpu")
    assert step.init_opt_states(None, 2, 3) == {}
    with pytest.raises(ValueError, match="make_optimizer steps"):
        TrainStep(LogisticRegression((F,), K), B, S, K, optimizer="rmsprop",
                  device="cpu")


# --------------------------------------------------------------------------
# One round on the reference's draws (parity level 2)

CASES = (("lr", "adam"), ("lr", "sgd"), ("fnn", "sgd"), ("fnn", "adam"))


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def jax_round(request):
    """One reference train_round at F = 784 on seeded data, with its draws
    and the module-level case (model, optimizer)."""
    import jax
    import jax.numpy as jnp
    model, optimizer = request.param
    seed = CASES.index(request.param)
    x, y = _data(seed)
    tw = _time_w(seed)
    jm, jp = _jax_pool(model, seed)
    jstep = _jax_step(jm, optimizer)
    key = jax.random.PRNGKey(20 + seed)
    out = jstep.train_round(
        jp, jstep.init_opt_states(jp, M, C), key, jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(tw), jnp.ones((M, C, N)),
        jnp.ones((M, F)), jnp.float32(0.5), with_agg_stats=True)
    return dict(model=model, optimizer=optimizer, x=x, y=y, tw=tw, jp=jp,
                out=out, draws=_jax_draws(key, tw))


def _param_atol(r):
    return ATOL if r["optimizer"] == "sgd" else ADAM_PARAM_ATOL


def _opt_to_port(module, jopt):
    st = jopt[1][0]
    return {"mu": _pack(module, st.mu), "nu": _pack(module, st.nu),
            "nu_max": _pack(module, st.nu_max),
            "count": torch.from_numpy(np.array(st.count, np.int32))}


def test_local_sgd_ref_matches_reference(jax_round):
    """Client params, optimizer state, n and loss of every pair, the
    inactive one included, against ``_local_sgd`` at lr_scale 0.5."""
    r = jax_round
    mod = _port_model(r["model"])
    client, opt, n, loss = local_sgd_ref(
        torch.from_numpy(r["x"]), torch.from_numpy(r["y"]), _pack(mod, r["jp"]),
        init_opt_state(M, C, mod.num_params, "cpu", r["optimizer"]),
        *r["draws"], torch.from_numpy(r["tw"]).sum(-1), hidden=mod.hidden_dim,
        batch_size=B, lr=LR, wd=WD, lr_scale=0.5, optimizer=r["optimizer"])
    _newp, jopt, jclient, jn, jloss, _stats, _ = r["out"]
    _close(client, _pack(mod, jclient), atol=_param_atol(r))
    _close(n, jn, atol=0)
    _close(loss, jloss)
    if r["optimizer"] == "sgd":
        assert opt == {}
    else:
        want = _opt_to_port(mod, jopt)
        _close(opt["mu"], want["mu"])
        for k in ("nu", "nu_max"):
            _close(opt[k], want[k], atol=1e-9, rtol=NU_RTOL)
        assert torch.equal(opt["count"], want["count"])
    assert n[1, 2] == 0
    assert torch.equal(client[1, 2], _pack(mod, r["jp"])[1])


def test_train_round_matches_reference(jax_round):
    """The port's round (K1's plain version, then K2's) with its new
    params and aggregation stats."""
    r = jax_round
    mod = _port_model(r["model"])
    step = TrainStep(mod, B, S, K, lr=LR, wd=WD, optimizer=r["optimizer"],
                     device="cpu")
    params = params_from_jax(r["jp"], "cpu")
    newp, _opt, client, n, losses, stats = step.train_round(
        params, step.init_opt_states(params, M, C), torch.from_numpy(r["x"]),
        torch.from_numpy(r["y"]), torch.from_numpy(r["tw"]), 0.5,
        draws=r["draws"], with_agg_stats=True)
    jnewp, _, jclient, jn, jloss, jstats, _ = r["out"]
    _close(mod.pack(newp), _pack(mod, jnewp), atol=_param_atol(r))
    _close(mod.pack(client), _pack(mod, jclient), atol=_param_atol(r))
    _close(n, jn, atol=0)
    _close(losses, jloss)
    _close(stats, jstats, atol=0)


# --------------------------------------------------------------------------
# The eval

@pytest.mark.parametrize("model,scale", [("lr", 1.0), ("lr", 40.0),
                                         ("fnn", 1.0)])
def test_eval_matches_reference(model, scale):
    """Correct counts and NLL sums per (model, client) against the
    reference's ``acc_matrix``; ``scale`` 40 saturates most lr outputs to
    exactly 1.0, so the lowest-index tie rule decides those rows."""
    import jax
    import jax.numpy as jnp
    jm, jp = _jax_pool(model, 7)
    jp = jax.tree_util.tree_map(lambda a: a * scale, jp)
    jstep = _jax_step(jm, "adam")
    mod = _port_model(model)
    flat = _pack(mod, jp)
    x, y = _data(8)
    fm = np.ones((M, F), np.float32)
    fm[1, ::3] = 0.0
    correct, nll = eval_cells(flat, torch.from_numpy(x[:, 1:3]),
                              torch.from_numpy(y[:, 1:3]),
                              hidden=mod.hidden_dim,
                              feat_mask=torch.from_numpy(fm))
    for g in range(2):
        wc, wl, _ = jstep.acc_matrix(jp, jnp.asarray(x[:, 1 + g]),
                                     jnp.asarray(y[:, 1 + g]),
                                     jnp.asarray(fm))
        assert np.array_equal(correct[..., g].numpy(), np.asarray(wc))
        np.testing.assert_allclose(nll[..., g].numpy(), np.asarray(wl),
                                   rtol=NLL_RTOL, atol=0)
    if scale > 1:
        out = mod({k: v[:, None, None] for k, v in mod.unpack(flat).items()},
                  torch.from_numpy(x[:, 1:3])[None])
        assert int((out == 1.0).sum(-1).ge(2).sum()) > 50   # tied rows


def test_eval_takes_the_first_of_tied_outputs():
    """Every output saturated to 1.0: each row predicts class 0, as
    ``jnp.argmax`` does, so exactly the rows labelled 0 count."""
    mod = LogisticRegression((F,), K)
    flat = torch.zeros(1, mod.num_params)
    flat[0, F * K:] = 50.0                                # bias only
    x, y = _data(9, c=1, t1=1)
    correct, _ = eval_cells_ref(flat, torch.from_numpy(x),
                                torch.from_numpy(y), hidden=0)
    assert int(correct) == int((y == 0).sum())


# --------------------------------------------------------------------------
# The slice: a run against the reference's

RUNS = (dict(dataset="MNIST", model="lr", client_optimizer="sgd",
             concept_drift_algo="oblivious"),
        dict(dataset="MNIST", model="lr", client_optimizer="adam",
             concept_drift_algo="oblivious"),
        dict(dataset="MNIST", model="fnn"),
        dict(dataset="sea", model="lr", client_optimizer="sgd",
             concept_drift_algo="oblivious", concept_drift_algo_arg="",
             concept_num=1, lr=0.05, seed=7))


@pytest.mark.parametrize("kw", RUNS, ids=lambda kw: "-".join(
    (kw["dataset"], kw["model"], kw.get("client_optimizer", "adam"))))
def test_run_tracks_the_reference(kw):
    """MNIST-4 and SEA through ``Experiment`` in both packages from the
    reference's initial pool, 4 clients, N = B = 40, T = 2, R = 10: step
    0's logged evals agree (the same batches); step 1's draws differ, so
    only its shape and finiteness are held."""
    import jax
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.simulation.runner import Experiment as JExp

    from feddrift_torch.simulation.runner import Experiment
    small = dict(kw, client_num_in_total=4, client_num_per_round=4,
                 sample_num=40, batch_size=40, train_iterations=2,
                 comm_round=10, frequency_of_the_test=5)
    jexp = JExp(JCfg(**small))
    init = jax.tree_util.tree_map(np.asarray, jexp.pool.params)
    jexp.run()
    exp = Experiment(ExperimentConfig(**small), device="cpu")
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


def test_resume_equals_the_continuous_run_under_lr_and_sgd(tmp_path):
    """The checkpoint holds what an lr / SGD run needs (SGD keeps no
    optimizer state; AMSGrad's is fresh at each step too)."""
    import json

    from feddrift_torch.simulation.runner import Experiment
    cfg = ExperimentConfig(dataset="MNIST", model="lr", client_optimizer="sgd",
                           concept_drift_algo="oblivious",
                           client_num_in_total=4, client_num_per_round=4,
                           sample_num=40, batch_size=20, train_iterations=3,
                           comm_round=10, seed=2)
    full = Experiment(cfg, out_dir=str(tmp_path / "full"), device="cpu")
    full.run()
    cut = Experiment(cfg, out_dir=str(tmp_path / "cut"), device="cpu")
    with cut.logger, cut.events:
        cut.run_iteration(0)
        cut.run_iteration(1)
    again = Experiment.resume(cfg, str(tmp_path / "cut"), device="cpu")
    assert isinstance(again.step.module, LogisticRegression)
    assert again.step.optimizer == "sgd" and again.start_iteration == 2
    again.run()
    rows = lambda h: [{k: v for k, v in r.items() if k != "_ts"} for r in h]
    read = [json.loads(line) for line in
            (tmp_path / "cut" / "metrics.jsonl").read_text().splitlines()]
    assert rows(read) == rows(full.logger.history)


# --------------------------------------------------------------------------
# On the card

# K1 on the card at F = 784 under AMSGrad (lr 0.01, five steps): the
# kernel and the plain version sum a gradient's 500 rows in other orders,
# so a rounding can flip a hidden unit's ReLU on a row; where a unit is
# active on few rows its weights' gradients are ~1e-6 and change sign, and
# AMSGrad's step normalises the gradient (lr * g / |g| at count 1), so such
# weights move up to 2 lr apart (0.0107 measured on the card). The plain
# float32 version is as far from exact math there, so the kernel is held to
# the plain version in float64 as the float32 one is: at most twice as
# many coordinates off by more than atol 1e-5 (params, mu) or rtol 1e-4
# (nu, nu_max), plus this fraction of them, as chip_smoke.py's
# WIDE_ADAM_SLACK.
CARD_ADAM_SLACK = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_round(model, seed, gather=False, masked=False):
    """K1's inputs at MNIST's canonical shape (M 4, C 10, T1 11, N = B =
    500): random pool, seeded weights with two pairs inactive."""
    rng = np.random.default_rng(seed)
    Mc, Cc, T1, Nc, Sc = 4, 10, 11, 500, 5
    mod = _port_model(model)
    flat = (rng.standard_normal((Mc, mod.num_params)) * 0.05)
    x, y = _data(seed, n=Nc, c=Cc, t1=T1)
    tw = (rng.random((Mc, Cc, T1)) < 0.5).astype(np.float32)
    tw[:, :, -1] = 0
    tw[0, 3] = tw[2, 7] = 0
    t_idx = rng.integers(0, T1 - 1, (Mc, Cc, Sc)).astype(np.int32)
    slot = np.zeros((Mc, Cc, Sc), np.int32)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    kw = dict(hidden=mod.hidden_dim, batch_size=Nc, lr=0.01, wd=0.001)
    if gather:
        kw["idx"] = dev(rng.integers(0, T1 * Nc, (Mc, Cc, Sc, Nc))
                        .astype(np.int32))
        t_idx = slot = None
    else:
        t_idx, slot = dev(t_idx), dev(slot)
    if masked:
        fm = (rng.random((Mc, F)) < 0.7).astype(np.float32)
        kw["feat_mask"] = dev(fm)
    return (dev(x), dev(y), dev(flat.astype(np.float32)), t_idx, slot,
            dev(tw.sum(-1))), kw, mod


@pytest.mark.gpu
@pytest.mark.parametrize("model,optimizer,gather,masked", [
    ("fnn", "adam", False, False), ("fnn", "adam", True, True),
    ("lr", "adam", False, False), ("lr", "sgd", False, True),
    ("fnn", "sgd", True, False)])
def test_general_kernel_matches_plain_at_mnist_width(cuda, model, optimizer,
                                                     gather, masked):
    """K1's general kernel, forced (MNIST's width takes the wide kernel
    by default: tests/test_torch_wide_kernels.py), on its lr and SGD routes
    against ``local_sgd_ref``:
    under SGD the params and losses at atol 1e-5; under AMSGrad as far
    from the plain version in float64 as the float32 plain version (see
    CARD_ADAM_SLACK; the losses within twice its distance plus 1e-5) and
    no param further than S steps of lr; n and count equal, inactive pairs
    untouched, two calls bitwise, one launch a call."""
    (x, y, flat, t_idx, slot, total_w), kw, mod = _card_round(
        model, 3, gather, masked)
    fresh = lambda: init_opt_state(4, 10, mod.num_params, "cuda", optimizer)
    launches = local_sgd.launches
    got = local_sgd(x, y, flat, fresh(), t_idx, slot, total_w,
                    optimizer=optimizer, route="general", **kw)
    again = local_sgd(x, y, flat, fresh(), t_idx, slot, total_w,
                      optimizer=optimizer, route="general", **kw)
    torch.cuda.synchronize()
    assert local_sgd.launches == launches + 2
    want = local_sgd_ref(x, y, flat, fresh(), t_idx, slot, total_w,
                         optimizer=optimizer, **kw)
    assert torch.equal(got[0], again[0]) and torch.equal(got[3], again[3])
    assert torch.equal(got[2], want[2])
    over = lambda a, b, atol=0.0, rtol=0.0: int(
        ((a - b).abs() > atol + rtol * b.abs()).sum())
    if optimizer == "sgd":
        assert got[1] == {} and want[1] == {}
        assert float((got[0] - want[0]).abs().max()) <= 1e-5
        assert float((got[3] - want[3]).abs().max()) <= 1e-5
    else:
        assert torch.equal(got[1]["count"], want[1]["count"])
        exact = local_sgd_ref(
            x.double(), y, flat.double(),
            {k: v.double() if v.is_floating_point() else v
             for k, v in fresh().items()}, t_idx, slot, total_w,
            optimizer=optimizer, **kw)
        off = [over(c.double(), exact[0], 1e-5)
               + over(o["mu"].double(), exact[1]["mu"], 1e-5)
               + sum(over(o[k].double(), exact[1][k], rtol=1e-4)
                     for k in ("nu", "nu_max"))
               for c, o in ((got[0], got[1]), (want[0], want[1]))]
        assert off[0] <= 2 * off[1] + CARD_ADAM_SLACK * 4 * got[0].numel()
        assert float((got[0] - want[0]).abs().max()) <= 5 * kw["lr"]
        loss_off = [float((l.double() - exact[3]).abs().max())
                    for l in (got[3], want[3])]
        assert loss_off[0] <= 2 * loss_off[1] + 1e-5
    inactive = total_w == 0
    assert torch.equal(got[0][inactive],
                       flat[:, None].expand_as(got[0])[inactive])


def _lr_near_ties(flat, x, fm, K_):
    """Rows per cell whose top two plain outputs lie within 1e-6 but are
    not equal (a 1-ulp difference may reorder those; exact ties may not
    be miscounted)."""
    w, b = (v[:, None, None] for v in _unpack(flat, x.shape[-1], 0, K_))
    xin = x[None] if fm is None else x[None] * fm[:, None, None, None, :]
    top = torch.sigmoid(xin @ w + b.unsqueeze(-2)).topk(2, dim=-1).values
    gap = top[..., 0] - top[..., 1]
    return ((gap <= 1e-6) & (gap > 0)).sum(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [1.0, 40.0])
@pytest.mark.parametrize("window", ["G2", "T1"])
def test_lr_eval_kernel_matches_plain(cuda, scale, window):
    """K3's general kernel's lr route on saturating and ordinary outputs
    (the wide kernel's: tests/test_torch_wide_kernels.py): counts equal but
    for near-tied (not exactly tied) rows, NLL to 1e-4 relative, two calls
    bitwise."""
    rng = np.random.default_rng(11)
    mod = LogisticRegression((F,), K)
    flat = torch.from_numpy((rng.standard_normal((4, mod.num_params))
                             * 0.05 * scale).astype(np.float32)).cuda()
    x, y = (torch.from_numpy(a).cuda() for a in _data(12, n=500, c=10,
                                                      t1=11))
    xw, yw = (x[:, 4:6], y[:, 4:6]) if window == "G2" else (x, y)
    nll_on = window == "G2"
    got = eval_cells(flat, xw, yw, hidden=0, with_nll=nll_on,
                     route="general")
    again = eval_cells(flat, xw, yw, hidden=0, with_nll=nll_on,
                       route="general")
    want = eval_cells_ref(flat, xw, yw, hidden=0, with_nll=nll_on)
    assert torch.equal(got[0], again[0])
    ties = _lr_near_ties(flat, xw, None, K)
    assert ((got[0] - want[0]).abs() <= ties).all()
    if nll_on:
        assert torch.equal(got[1], again[1])
        assert ((got[1] - want[1]).abs() <= 1e-4 * want[1].abs()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("window", ["G2", "T1"])
def test_fnn_eval_kernel_matches_plain_at_mnist_width(cuda, window):
    """K3's general kernel, forced, on MNIST's fnn (F 784, H 10, K 10;
    its shared memory above 48 KB at 512 threads): counts equal but for
    rows whose top two plain logits lie within 1e-5, NLL to 1e-4
    relative, two calls bitwise."""
    rng = np.random.default_rng(13)
    mod = FeedForwardNN((F,), K, H)
    flat = torch.from_numpy((rng.standard_normal((4, mod.num_params))
                             * 0.05).astype(np.float32)).cuda()
    x, y = (torch.from_numpy(a).cuda() for a in _data(14, n=500, c=10,
                                                      t1=11))
    xw, yw = (x[:, 4:6], y[:, 4:6]) if window == "G2" else (x, y)
    nll_on = window == "G2"
    got = eval_cells(flat, xw, yw, hidden=H, with_nll=nll_on,
                     route="general")
    again = eval_cells(flat, xw, yw, hidden=H, with_nll=nll_on,
                       route="general")
    want = eval_cells_ref(flat, xw, yw, hidden=H, with_nll=nll_on)
    assert torch.equal(got[0], again[0])
    leaves = [v[:, None, None] for v in _unpack(flat, F, H, K)]
    w0, b0, w1, b1 = leaves
    z = torch.relu(xw[None] @ w0 + b0.unsqueeze(-2)) @ w1 + b1.unsqueeze(-2)
    top = z.topk(2, dim=-1).values
    ties = ((top[..., 0] - top[..., 1]) <= 1e-5).sum(-1)
    assert ((got[0] - want[0]).abs() <= ties).all()
    if nll_on:
        assert torch.equal(got[1], again[1])
        assert ((got[1] - want[1]).abs() <= 1e-4 * want[1].abs()).all()
