"""NaN and Inf through K1's and K3's plain versions as through the JAX
package, on the CPU.

A poisoned pool (model 0 has a NaN in ``Dense_0/kernel``, model 1 an Inf
in ``Dense_1/bias``, the lr's in ``Dense_0/bias``) goes through one round
of the port's plain K1 (``local_sgd_ref``) and K1 + K2
(``local_sgd_fedavg_ref``) and through the reference's ``train_round``
(``_local_sgd`` under ``_round_body``'s vmap, then the masked FedAvg), on
the reference's own batch draws; and through the plain K3
(``eval_cells_ref``, via ``TrainStep.acc_matrix`` / ``acc_cells``) and the
reference's ``_acc_matrix_body``. Every output's finiteness pattern must
be the reference's cell for cell, the eval counts equal (jnp.argmax and
torch.argmax both pick the first NaN) and the NLL sums equal where finite.
The plain K1 takes jax.nn.relu's gradient, 0 where the pre-activation is
NaN (``kernels/eval_cells.py::_Relu``): torch.relu's would pass the NaN
through and leave more of the client params non-finite than the
reference does. ``chip_smoke.py``'s ``nan_semantics`` phase holds the
kernels to these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddrift_torch.convert import params_from_jax
from feddrift_torch.core.step import TrainStep
from feddrift_torch.kernels.local_sgd import (init_opt_state,
                                              local_sgd_fedavg_ref,
                                              local_sgd_ref)
from feddrift_torch.models.mlp import FeedForwardNN, LogisticRegression
from torch_threads import one_intra_op_thread  # noqa: F401

M, C, T, N, B, S = 3, 4, 2, 40, 20, 4
LR, WD = 0.05, 0.001


def _data(seed, F, K):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (C, T + 1, N, F)).astype(np.float32)
    y = rng.integers(0, K, (C, T + 1, N)).astype(np.int32)
    return x, y


def _time_w(seed):
    rng = np.random.default_rng(seed + 100)
    tw = (rng.random((M, C, T + 1)) < 0.6).astype(np.float32)
    tw[:, :, T] = 0.0
    tw[2, 3, :] = 0.0                      # an inactive pair
    tw[:2, :, :T] = 1.0                    # the poisoned models train
    return tw


def _draws(key, time_w):
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


def _setup(model, optimizer, F, K, seed=0):
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    from feddrift_tpu.models.mlp import LogisticRegression as JLr
    H = 0 if model == "lr" else 6
    jm = JLr(num_classes=K) if model == "lr" else JFnn(num_classes=K,
                                                        hidden_dim=H)
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    jp = jax.vmap(lambda k: jm.init(k, jnp.zeros((1, F)))["params"])(keys)
    jp = jax.tree_util.tree_map(np.array, jp)
    jp["Dense_0"]["kernel"][0, 1, 2 % max(H, K)] = np.nan
    bias = "Dense_0" if model == "lr" else "Dense_1"
    jp[bias]["bias"][1, 0] = np.inf
    jstep = JStep(lambda p, x: jm.apply({"params": p}, x),
                  make_optimizer(optimizer, LR, WD), B, S, K)
    mod = LogisticRegression((F,), K) if model == "lr" \
        else FeedForwardNN((F,), K, H)
    return jp, jstep, mod, H


def _fin(a):
    return np.isfinite(np.asarray(a))


CASES = [("fnn", "adam", 3, 2), ("fnn", "sgd", 3, 2), ("fnn", "adam", 8, 3),
         ("lr", "adam", 8, 3), ("lr", "sgd", 8, 3)]


@pytest.mark.parametrize("model,optimizer,F,K", CASES,
                         ids=[f"{m}-{o}-F{f}" for m, o, f, _ in CASES])
def test_k1_plain_nan_pattern_is_the_reference(model, optimizer, F, K):
    x, y = _data(1, F, K)
    tw = _time_w(1)
    jp, jstep, mod, H = _setup(model, optimizer, F, K)
    key = jax.random.PRNGKey(5)
    out = jstep.train_round(
        jp, jstep.init_opt_states(jp, M, C), key, jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(tw), jnp.ones((M, C, N)),
        jnp.ones((M, F)), jnp.float32(1.0), with_agg_stats=True)
    jnew, jopt, jclient, jn, jloss = out[:5]
    t_idx, slot = _draws(key, tw)
    flat = mod.pack(params_from_jax(jp, "cpu"))
    kw = dict(hidden=H, batch_size=B, lr=LR, wd=WD, optimizer=optimizer)
    opt0 = init_opt_state(M, C, mod.num_params, "cpu", optimizer)
    client, opt, n, loss = local_sgd_ref(
        torch.from_numpy(x), torch.from_numpy(y), flat, opt0, t_idx, slot,
        torch.from_numpy(tw).sum(-1), **kw)
    pack = lambda tree: mod.pack(params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), "cpu"))
    assert not _fin(client).all() and _fin(client).any()
    assert (_fin(client) == _fin(pack(jclient))).all()
    assert (_fin(loss) == _fin(jloss)).all()
    assert np.array_equal(n.numpy(), np.asarray(jn))
    if optimizer == "adam":
        st = jopt[1][0]
        for k, v in (("mu", st.mu), ("nu", st.nu), ("nu_max", st.nu_max)):
            assert (_fin(opt[k]) == _fin(pack(v))).all(), k
    opt0 = init_opt_state(M, C, mod.num_params, "cpu", optimizer)
    kw.pop("optimizer")
    if optimizer == "adam":                 # the fused route: K1 + K2
        *_, new, _stats = local_sgd_fedavg_ref(
            torch.from_numpy(x), torch.from_numpy(y), flat, opt0, t_idx,
            slot, torch.from_numpy(tw).sum(-1), **kw)
        assert (_fin(new) == _fin(pack(jnew))).all()


@pytest.mark.parametrize("model,F,K", [("fnn", 3, 2), ("fnn", 8, 3),
                                       ("lr", 8, 3)])
def test_k3_plain_nan_counts_are_the_reference(model, F, K):
    x, y = _data(2, F, K)
    jp, jstep, mod, H = _setup(model, "adam", F, K, seed=3)
    step = TrainStep(mod, B, S, K, device="cpu")
    params = params_from_jax(jp, "cpu")
    correct, nll, total = step.acc_matrix(
        params, torch.from_numpy(x[:, 0]), torch.from_numpy(y[:, 0]))
    jc, jl, jt = jstep.acc_matrix(jp, jnp.asarray(x[:, 0]),
                                  jnp.asarray(y[:, 0]), jnp.ones((M, F)))
    assert np.array_equal(correct.numpy(), np.asarray(jc))
    assert (_fin(nll) == _fin(jl)).all() and not _fin(nll).all()
    both = _fin(nll)
    np.testing.assert_allclose(nll.numpy()[both], np.asarray(jl)[both],
                               rtol=1e-5)
    cells = step.acc_cells(params, torch.from_numpy(x),
                           torch.from_numpy(y))
    want = jstep.acc_cells(jp, jnp.asarray(x), jnp.asarray(y),
                           jnp.ones((M, F)))
    assert np.array_equal(cells.numpy(), np.asarray(want))
