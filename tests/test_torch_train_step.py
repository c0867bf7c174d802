"""The port's training step (K1's plain version, the round, the eval
matrices) against the JAX ``TrainStep`` on the CPU.

Both packages get the same seeded numpy data and the same parameters
(flax's, carried across with ``params_from_jax``). The reference draws its
batches inside the program from fold_in keys; the tests reproduce that key
path (``split(key, M·C)`` -> ``split(k, S)`` -> ``split(k)`` into k1, k2 ->
``categorical(k1, log(w_safe + 1e-30))``, ``randint(k2, (), 0, nb)``) and
inject the resulting indices into the port.

Tolerances: params, optimizer moments and losses at atol 2e-6 (float32;
the two packages sum the 20-40 batch rows of a gradient in other orders,
~1e-7 relative, and AMSGrad's steps are ~lr = 0.05 in size); nu and
nu_max, which are squares of gradients ~1e-2, at rtol 1e-4; n exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.convert import params_from_jax
from feddrift_torch.core.step import TrainStep
from feddrift_torch.kernels.local_sgd import (_route, _unpack, amsgrad_step,
                                              init_opt_state, local_sgd,
                                              local_sgd_fedavg, local_sgd_ref)
from feddrift_torch.models.mlp import FeedForwardNN
from feddrift_torch.resilience.robust_agg import agg_mean
from torch_threads import one_intra_op_thread  # noqa: F401

M, C, T, N, B, S, H, LR, WD = 3, 4, 2, 40, 20, 4, 6, 0.05, 0.001
ATOL = 2e-6
NU_RTOL = 1e-4


def _data(seed=0, F=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (C, T + 1, N, F)).astype(np.float32)
    y = (x[..., 0] + 0.3 * rng.standard_normal((C, T + 1, N)) > 0.5) \
        .astype(np.int32)
    return x, y


def _time_w(seed=0):
    rng = np.random.default_rng(seed + 100)
    tw = (rng.random((M, C, T + 1)) < 0.6).astype(np.float32)
    tw[:, :, T] = 0.0                      # the test step never trains
    tw[0, 0, :] = 0.0                      # inactive pairs
    tw[2, 3, :] = 0.0
    tw[1, 1, :T] = 1.0
    return tw


def _jax_setup(F=3, seed=0, num_steps=S):
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    jm = JFnn(num_classes=2, hidden_dim=H)
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    params = jax.vmap(lambda k: jm.init(k, jnp.zeros((1, F)))["params"])(keys)
    step = JStep(lambda p, x: jm.apply({"params": p}, x),
                 make_optimizer("adam", LR, WD), B, num_steps, 2)
    return jm, params, step


def _module(F=3):
    return FeedForwardNN((F,), num_classes=2, hidden_dim=H)


def _pack(module, tree):
    return module.pack(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              tree), "cpu"))


def _jax_draws(key, time_w, num_steps=S, nb=N // B):
    """The reference's batch indices of one round, [M, C, S] each."""
    keys = jax.random.split(key, M * C).reshape(M, C, 2)

    def pair(k, w):
        w_safe = jnp.where(w.sum() > 0, w, jnp.ones_like(w))
        logits = jnp.log(w_safe + 1e-30)

        def one(kk):
            k1, k2 = jax.random.split(kk)
            return (jax.random.categorical(k1, logits),
                    jax.random.randint(k2, (), 0, nb))
        return jax.vmap(one)(jax.random.split(k, num_steps))
    t_idx, slot = jax.vmap(jax.vmap(pair))(keys, jnp.asarray(time_w))
    return (torch.from_numpy(np.array(t_idx, np.int32)),
            torch.from_numpy(np.array(slot, np.int32)))


def _opt_to_port(module, jopt):
    st = jopt[1][0]
    return {"mu": _pack(module, st.mu), "nu": _pack(module, st.nu),
            "nu_max": _pack(module, st.nu_max),
            "count": torch.from_numpy(np.array(st.count, np.int32))}


def _close(a, b, atol=ATOL, rtol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def jax_round():
    """One reference train_round on seeded data, with its draws."""
    x, y = _data()
    tw = _time_w()
    jm, jp, jstep = _jax_setup()
    opt = jstep.init_opt_states(jp, M, C)
    key = jax.random.PRNGKey(11)
    out = jstep.train_round(
        jp, opt, key, jnp.asarray(x), jnp.asarray(y), jnp.asarray(tw),
        jnp.ones((M, C, N)), jnp.ones((M, 3)), jnp.float32(1.0),
        with_agg_stats=True)
    return dict(x=x, y=y, tw=tw, jp=jp, out=out, draws=_jax_draws(key, tw))


class TestLocalSGDRef:
    def test_matches_reference_local_sgd(self, jax_round):
        """Client params, opt state, n and loss of every pair, inactive
        pairs included, against _local_sgd under _round_body's vmap."""
        r = jax_round
        mod = _module()
        t_idx, slot = r["draws"]
        client, opt, n, loss = local_sgd_ref(
            torch.from_numpy(r["x"]), torch.from_numpy(r["y"]),
            _pack(mod, r["jp"]), init_opt_state(M, C, mod.num_params, "cpu"),
            t_idx, slot, torch.from_numpy(r["tw"]).sum(-1), hidden=H,
            batch_size=B, lr=LR, wd=WD)
        _newp, jopt, jclient, jn, jloss, _stats, _ = r["out"]
        _close(client, _pack(mod, jclient))
        _close(n, jn, atol=0)
        _close(loss, jloss)
        want = _opt_to_port(mod, jopt)
        _close(opt["mu"], want["mu"])
        for k in ("nu", "nu_max"):
            _close(opt[k], want[k], atol=1e-9, rtol=NU_RTOL)
        assert torch.equal(opt["count"], want["count"])
        # inactive pairs: untouched params and state, n = 0, loss reported
        for m, c in ((0, 0), (2, 3)):
            assert n[m, c] == 0 and loss[m, c] > 0
            assert torch.equal(client[m, c], _pack(mod, r["jp"])[m])
            assert int(opt["count"][m, c]) == 0

    def test_wrapper_takes_plain_version_on_cpu(self, jax_round):
        r = jax_round
        mod = _module()
        before = local_sgd.launches
        args = (torch.from_numpy(r["x"]), torch.from_numpy(r["y"]),
                _pack(mod, r["jp"]), init_opt_state(M, C, mod.num_params,
                                                    "cpu"),
                *r["draws"], torch.from_numpy(r["tw"]).sum(-1))
        kw = dict(hidden=H, batch_size=B, lr=LR, wd=WD)
        got = local_sgd(*args, **kw)
        want = local_sgd_ref(*args, **kw)
        assert local_sgd.launches == before      # no kernel on the CPU
        for a, b in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("F", [2, 3])
    def test_feature_widths(self, F):
        """F = 2 (sine, circle) and 3 (SEA) through the reference's step."""
        x, y = _data(3, F)
        tw = _time_w(3)
        jm, jp, jstep = _jax_setup(F, seed=3)
        opt = jstep.init_opt_states(jp, M, C)
        key = jax.random.PRNGKey(5)
        _p, _o, jclient, jn, jloss = jstep.train_round(
            jp, opt, key, jnp.asarray(x), jnp.asarray(y), jnp.asarray(tw),
            jnp.ones((M, C, N)), jnp.ones((M, F)), jnp.float32(1.0))
        mod = _module(F)
        client, _, n, loss = local_sgd_ref(
            torch.from_numpy(x), torch.from_numpy(y), _pack(mod, jp),
            init_opt_state(M, C, mod.num_params, "cpu"),
            *_jax_draws(key, tw), torch.from_numpy(tw).sum(-1), hidden=H,
            batch_size=B, lr=LR, wd=WD)
        _close(client, _pack(mod, jclient))
        _close(loss, jloss)


class TestAMSGrad:
    def test_matches_optax_chain_over_20_steps(self):
        from feddrift_tpu.core.step import make_optimizer
        rng = np.random.default_rng(0)
        p0 = rng.standard_normal(37).astype(np.float32)
        grads = rng.standard_normal((20, 37)).astype(np.float32) \
            * np.logspace(-4, 0, 37, dtype=np.float32)
        opt = make_optimizer("adam", LR, WD)
        jp, js = jnp.asarray(p0), opt.init(jnp.asarray(p0))
        p = torch.from_numpy(p0)
        mu, nu, vmax = (torch.zeros(37) for _ in range(3))
        count = torch.zeros((), dtype=torch.int32)
        for g in grads:
            u, js = opt.update(jnp.asarray(g), js, jp)
            jp = jp + u
            p, mu, nu, vmax, count = amsgrad_step(
                p, torch.from_numpy(g), mu, nu, vmax, count, lr=LR, wd=WD)
        _close(p, jp)
        _close(vmax, js[1][0].nu_max, atol=0, rtol=NU_RTOL)
        assert int(count) == int(js[1][0].count) == 20

    def test_max_is_of_the_corrected_nu(self):
        """optax keeps max(nu_max, nu_hat) of the bias-corrected nu, not
        torch.optim.Adam(amsgrad=True)'s max of the raw nu."""
        z = torch.zeros(1)
        _, _, nu, vmax, _ = amsgrad_step(
            z, torch.ones(1), z, z, z, torch.zeros((), dtype=torch.int32),
            lr=LR, wd=0.0)
        assert float(nu) == pytest.approx(0.001, rel=1e-6)
        # 0.001 / (1 - 0.999) in float32
        assert float(vmax) == pytest.approx(1.0, rel=1e-4)


class TestTrainRound:
    def _port(self, F=3):
        mod = _module(F)
        return mod, TrainStep(mod, B, S, 2, lr=LR, wd=WD, device="cpu")

    def test_round_matches_reference(self, jax_round):
        r = jax_round
        mod, step = self._port()
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, r["jp"]),
                                 "cpu")
        newp, _opt, client, n, losses, stats = step.train_round(
            params, step.init_opt_states(params, M, C),
            torch.from_numpy(r["x"]), torch.from_numpy(r["y"]),
            torch.from_numpy(r["tw"]), draws=r["draws"], with_agg_stats=True)
        jnewp, _, jclient, jn, jloss, jstats, _ = r["out"]
        _close(mod.pack(newp), _pack(mod, jnewp))
        _close(mod.pack(client), _pack(mod, jclient))
        _close(n, jn, atol=0)
        _close(losses, jloss)
        _close(stats, jstats, atol=0)

    def test_fused_round_plain_version_matches_reference(self, jax_round):
        """The fused round's plain version (``local_sgd_fedavg`` on the
        CPU: ``local_sgd_ref``, then ``fedavg_ref`` with the params as
        prev) against the reference's ``_round_body`` on its own draws."""
        r = jax_round
        mod = _module()
        flat = _pack(mod, r["jp"])
        tw = torch.from_numpy(r["tw"])
        client, opt, n, losses, agg, stats = local_sgd_fedavg(
            torch.from_numpy(r["x"]), torch.from_numpy(r["y"]), flat,
            init_opt_state(M, C, mod.num_params, "cpu"), *r["draws"],
            tw.sum(-1), hidden=H, batch_size=B, lr=LR, wd=WD)
        jnewp, _, jclient, jn, jloss, jstats, _ = r["out"]
        _close(agg, _pack(mod, jnewp))
        _close(client, _pack(mod, jclient))
        _close(n, jn, atol=0)
        _close(losses, jloss)
        _close(stats, jstats, atol=0)

    @pytest.mark.parametrize("sampled", [(0, 2), (1, 2, 3)])
    def test_masked_round_matches_reference(self, sampled):
        """A client mask (client sampling): the reference's
        ``train_round(client_mask=...)`` under its own draws, injected.
        Unsampled clients keep their params and report n = 0."""
        x, y = _data(7)
        tw = _time_w(7)
        mask = np.zeros(C, np.float32)
        mask[list(sampled)] = 1.0
        jm, jp, jstep = _jax_setup(seed=7)
        key = jax.random.PRNGKey(17)
        jout = jstep.train_round(
            jp, jstep.init_opt_states(jp, M, C), key, jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(tw), jnp.ones((M, C, N)),
            jnp.ones((M, 3)), jnp.float32(1.0), jnp.asarray(mask),
            with_agg_stats=True)
        mod, step = self._port()
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")
        newp, opt, client, n, losses, stats = step.train_round(
            params, step.init_opt_states(params, M, C),
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(tw),
            1.0, torch.from_numpy(mask),
            draws=_jax_draws(key, tw * mask[None, :, None]),
            with_agg_stats=True)
        jnewp, jopt, jclient, jn, jloss, jstats, _ = jout
        _close(mod.pack(newp), _pack(mod, jnewp))
        _close(mod.pack(client), _pack(mod, jclient))
        _close(losses, jloss)
        _close(n, jn, atol=0)
        _close(stats, jstats, atol=0)
        out = [c for c in range(C) if c not in sampled]
        assert (n[:, out] == 0).all() and (opt["count"][:, out] == 0).all()
        flat = mod.pack(params)
        for c in out:
            assert torch.equal(mod.pack(client)[:, c], flat)

    def _round(self, tw, lr_scale=1.0, seed=0):
        x, y = _data(seed)
        mod, step = self._port()
        params = mod.unpack(torch.stack(
            [mod.pack(mod.init_params(torch.Generator().manual_seed(m), "cpu"))
             for m in range(M)]))
        step.generator.manual_seed(seed)
        out = step.train_round(params, step.init_opt_states(params, M, C),
                               torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(tw), lr_scale)
        return mod, params, out

    def test_unused_models_untouched(self):
        tw = np.zeros((M, C, T + 1), np.float32)
        tw[0, :, 0] = 1.0          # only model 0 trains
        mod, params, (newp, _, _, n, _) = self._round(tw)
        assert (n[0] == N).all() and (n[1:] == 0).all()
        flat, new = mod.pack(params), mod.pack(newp)
        assert not torch.equal(new[0], flat[0])
        assert torch.equal(new[1:], flat[1:])

    def test_zero_weight_clients_masked(self):
        tw = np.zeros((M, C, T + 1), np.float32)
        tw[0, :2, 0] = 1.0         # model 0: only clients 0, 1 take part
        mod, params, (_, _, client, n, _) = self._round(tw)
        assert (n[0, :2] == N).all() and (n[0, 2:] == 0).all()
        flat = mod.pack(params)
        assert torch.equal(mod.pack(client)[0, 2], flat[0])
        assert torch.equal(mod.pack(client)[0, 3], flat[0])

    def test_aggregation_is_weighted_mean(self):
        tw = np.zeros((M, C, T + 1), np.float32)
        tw[0, 0, :2] = 1.0         # client 0 on steps 0 and 1 (n = 2N)
        tw[0, 1, 0] = 1.0          # client 1 on step 0 (n = N)
        mod, _, (newp, _, client, n, _) = self._round(tw, seed=1)
        assert n[0, 0] == 2 * N and n[0, 1] == N
        cp = mod.pack(client)
        manual = (cp[0, 0] * 2 * N + cp[0, 1] * N) / (3 * N)
        _close(mod.pack(newp)[0], manual, atol=1e-6)

    def test_lr_scale_zero_freezes(self):
        tw = np.ones((M, C, T + 1), np.float32)
        mod, params, (newp, *_) = self._round(tw, lr_scale=0.0)
        assert torch.equal(mod.pack(newp), mod.pack(params))

    def test_same_generator_seed_same_round(self):
        tw = np.ones((M, C, T + 1), np.float32)
        mod, _, a = self._round(tw, seed=4)
        _, _, b = self._round(tw, seed=4)
        assert torch.equal(mod.pack(a[0]), mod.pack(b[0]))

    def test_draws_follow_the_weights(self):
        _, step = self._port()
        tw = torch.zeros(M, C, T + 1)
        tw[:, :, 1] = 1.0
        tw[0, 0] = 0.0             # inactive pair: uniform over T1
        step.generator.manual_seed(0)
        t_idx, slot = step.draw_batches(tw, 50, N)
        assert t_idx.shape == slot.shape == (50, M, C, S)
        assert t_idx.dtype == slot.dtype == torch.int32
        assert (t_idx[:, 1:] == 1).all() and (t_idx[:, 0, 1:] == 1).all()
        assert set(t_idx[:, 0, 0].flatten().tolist()) == {0, 1, 2}
        assert set(slot.flatten().tolist()) == {0, 1}


class TestDraws:
    """Batch draws: ``t_idx`` from uniforms by the inverse CDF of a
    round's weights, the reference's ``weight_cdf`` /
    ``inverse_cdf_draw`` arithmetic."""

    def test_inverse_cdf_matches_reference(self):
        from feddrift_tpu.core.step import weight_cdf
        rng = np.random.default_rng(3)
        tw = _time_w(3) * rng.uniform(0.5, 4.0, (M, C, T + 1)).astype(
            np.float32)
        u = rng.random((M, C, 64)).astype(np.float32)
        u[0, 1, :3] = (0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5)
        got = TrainStep.time_index(torch.from_numpy(tw), torch.from_numpy(u))
        assert got.dtype == torch.int32 and got.shape == (M, C, 64)
        for m in range(M):
            for c in range(C):
                w = tw[m, c] if tw[m, c].sum() > 0 else np.ones(T + 1,
                                                                np.float32)
                want = jnp.clip(jnp.searchsorted(
                    weight_cdf(jnp.asarray(w)), jnp.asarray(u[m, c]),
                    side="right"), 0, T)
                assert np.array_equal(got[m, c].numpy(), np.asarray(want))
                assert (tw[m, c][got[m, c].numpy()] > 0).all() \
                    or tw[m, c].sum() == 0

    def test_rounds_at_once_equal_round_by_round(self):
        """The fused loop converts all R rounds at once, the per-round
        loop one row at a time: the same indices, bitwise."""
        _, step = TestTrainRound()._port()
        tw = torch.from_numpy(_time_w(4))
        step.generator.manual_seed(9)
        u, slot = step.draw_uniforms(6, M, C, N)
        assert u.shape == slot.shape == (6, M, C, S)
        at_once = step.time_index(tw, u)
        for r in range(6):
            assert torch.equal(at_once[r], step.time_index(tw, u[r]))
        step.generator.manual_seed(9)
        assert torch.equal(step.draw_batches(tw, 6, N)[0], at_once)


class TestAggregation:
    @pytest.mark.parametrize("seed", [2, 3, 4])
    def test_mean_matches_reference(self, seed):
        from feddrift_tpu.resilience import robust_agg as jagg
        rng = np.random.default_rng(seed)
        cp = rng.standard_normal((M, C, 7)).astype(np.float32)
        prev = rng.standard_normal((M, 7)).astype(np.float32)
        n = (rng.random((M, C)) * 80).astype(np.float32)
        n[1] = 0.0                  # a cluster with no active client
        n[2, :2] = 0.0
        got, stats = agg_mean(torch.from_numpy(cp), torch.from_numpy(n),
                              torch.from_numpy(prev))
        want, wstats = jagg.aggregate("mean", jnp.asarray(cp), jnp.asarray(n),
                                      jnp.asarray(prev), None,
                                      jagg.RobustAggConfig())
        _close(got, want, atol=1e-6)
        assert torch.equal(got[1], torch.from_numpy(prev)[1])
        _close(stats, wstats, atol=0)
        assert stats[:, 0].tolist() == [C, 0, C - 2]


class TestEval:
    def _both(self, seed=0):
        x, y = _data(seed)
        jm, jp, jstep = _jax_setup(seed=seed)
        mod = _module()
        step = TrainStep(mod, B, S, 2, device="cpu")
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        return x, y, jm, jp, jstep, mod, step, params

    def test_acc_matrix_matches_reference_and_manual(self):
        x, y, jm, jp, jstep, mod, step, params = self._both()
        correct, loss_sum, total = step.acc_matrix(
            params, torch.from_numpy(x[:, 0]), torch.from_numpy(y[:, 0]))
        jc, jl, jt = jstep.acc_matrix(jp, jnp.asarray(x[:, 0]),
                                      jnp.asarray(y[:, 0]), jnp.ones((M, 3)))
        assert correct.dtype == torch.int32
        assert np.array_equal(correct.numpy(), np.asarray(jc))
        _close(loss_sum, jl, atol=1e-4)           # sums of 40 f32 NLLs
        assert np.array_equal(total.numpy(), np.asarray(jt))
        one = {k: v[1] for k, v in params.items()}
        logits = mod(one, torch.from_numpy(x[2, 0]))
        manual = int((logits.argmax(-1) == torch.from_numpy(y[2, 0])).sum())
        assert int(correct[1, 2]) == manual

    def test_acc_cells_matches_reference(self):
        x, y, jm, jp, jstep, mod, step, params = self._both(1)
        cells = step.acc_cells(params, torch.from_numpy(x), torch.from_numpy(y))
        want = jstep.acc_cells(jp, jnp.asarray(x), jnp.asarray(y),
                               jnp.ones((M, 3)))
        assert cells.shape == (M, C, T + 1) and cells.dtype == torch.int32
        assert np.array_equal(cells.numpy(), np.asarray(want))


class TestIterationEval:
    def test_fused_iteration_matches_reference(self):
        """R rounds + the eval buffers of train_iteration_eval, with the
        reference's fold_in(iter_key, r) draws injected round by round."""
        R, freq, t = 7, 3, 1
        x, y = _data(5)
        tw = _time_w(5)
        jm, jp, jstep = _jax_setup(seed=5)
        jp = jax.tree_util.tree_map(np.asarray, jp)   # the call donates its
        it_key = jax.random.PRNGKey(21)               # params buffers
        jout = jstep.train_iteration_eval(
            jax.tree_util.tree_map(jnp.asarray, jp),
            jstep.init_opt_states(jp, M, C), it_key, jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(tw), jnp.ones((M, C, N)),
            jnp.ones((M, 3)), jnp.float32(1.0), R, freq, jnp.int32(t),
            with_agg_stats=True)
        draws = [_jax_draws(jax.random.fold_in(it_key, r), tw)
                 for r in range(R)]
        draws = tuple(torch.stack([d[i] for d in draws]) for i in (0, 1))
        mod = _module()
        step = TrainStep(mod, B, S, 2, lr=LR, wd=WD, device="cpu")
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        out = step.train_iteration_eval(
            params, step.init_opt_states(params, M, C), torch.from_numpy(x),
            torch.from_numpy(y), torch.from_numpy(tw), 1.0, R, freq, t,
            draws=draws)
        newp, _, n, losses, bufs, total, stats = out
        jp2, _, jn, jl, jbufs, jtot, jstats = jout
        assert step.eval_rounds(R, freq) == [0, 3, 6]
        _close(mod.pack(newp), _pack(mod, jp2), atol=1e-5)   # 7 rounds
        _close(n, jn, atol=0)
        _close(losses, jl, atol=1e-5)
        for got, want in zip(bufs, jbufs):
            assert got.shape == (3, M, C)
            if got.dtype == torch.int32:
                assert np.abs(got.numpy() - np.asarray(want)).max() <= 1
            else:
                _close(got, want, atol=1e-3)
        assert np.array_equal(total.numpy(), np.asarray(jtot))
        _close(stats, jstats, atol=0)


    def test_fused_iteration_with_masks_matches_reference(self):
        """``client_masks [R, C]``: round r samples row r's clients, as the
        reference's fused program does."""
        R, freq, t = 5, 2, 1
        x, y = _data(6)
        tw = _time_w(6)
        masks = np.zeros((R, C), np.float32)
        for r in range(R):
            masks[r, np.random.RandomState(r).choice(C, 2, replace=False)] = 1
        jm, jp, jstep = _jax_setup(seed=6)
        jp = jax.tree_util.tree_map(np.asarray, jp)
        it_key = jax.random.PRNGKey(23)
        jout = jstep.train_iteration_eval(
            jax.tree_util.tree_map(jnp.asarray, jp),
            jstep.init_opt_states(jp, M, C), it_key, jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(tw), jnp.ones((M, C, N)),
            jnp.ones((M, 3)), jnp.float32(1.0), R, freq, jnp.int32(t),
            jnp.asarray(masks))
        draws = [_jax_draws(jax.random.fold_in(it_key, r),
                            tw * masks[r][None, :, None]) for r in range(R)]
        draws = tuple(torch.stack([d[i] for d in draws]) for i in (0, 1))
        mod = _module()
        step = TrainStep(mod, B, S, 2, lr=LR, wd=WD, device="cpu")
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        newp, _, n, losses, bufs, _, stats = step.train_iteration_eval(
            params, step.init_opt_states(params, M, C), torch.from_numpy(x),
            torch.from_numpy(y), torch.from_numpy(tw), 1.0, R, freq, t,
            torch.from_numpy(masks), draws=draws)
        jp2, _, jn, jl, jbufs, _ = jout
        _close(mod.pack(newp), _pack(mod, jp2), atol=1e-5)
        _close(n, jn, atol=0)
        assert (n[:, masks[-1] == 0] == 0).all()
        _close(losses, jl, atol=1e-5)
        for got, want in zip(bufs, jbufs):
            if got.dtype == torch.int32:
                assert np.abs(got.numpy() - np.asarray(want)).max() <= 1
            else:
                _close(got, want, atol=1e-3)


def test_step_refuses_what_the_kernel_does_not_train():
    with pytest.raises(ValueError):
        TrainStep(_module(), B, S, 2, optimizer="rmsprop", device="cpu")
    cfg = ExperimentConfig()
    with pytest.raises(NotImplementedError):
        TrainStep.create(cfg, torch.nn.Identity(), 2, device="cpu")


class TestKernelRoute:
    @pytest.mark.parametrize("dataset", ["sea", "sine", "circle"])
    def test_registry_defaults_take_the_fused_kernel(self, dataset):
        from feddrift_torch.data.registry import make_dataset
        from feddrift_torch.models import create_model
        cfg = ExperimentConfig(dataset=dataset,
                               change_points="A" if dataset == "sea" else "W")
        ds = make_dataset(cfg)
        mod = create_model("fnn", ds, cfg)
        F, H, K = ds.x.shape[-1], mod.hidden_dim, mod.num_classes
        assert (F, H, K) == ((3 if dataset == "sea" else 2), 10, 2)
        assert _route(F, H, K, min(cfg.batch_size, ds.x.shape[2])) == "fused"

    @pytest.mark.parametrize("F,H,K,B", [(3, 32, 2, 500), (2, 32, 2, 500),
                                         (784, 10, 10, 500), (3, 10, 2, 513),
                                         (3, 10, 3, 500)])
    def test_other_shapes_take_the_general_kernel(self, F, H, K, B):
        # MNIST's width takes the wide kernel (tests/test_torch_wide_kernels)
        assert _route(F, H, K, B) == ("wide" if F == 784 else "general")



def _fold_warp(v):
    """The fused K1 kernel's transpose-reduce of one warp, in float32: ``v
    [32 lanes, V]``; in each of five butterfly rounds (lane bit 16, 8, 4,
    2, 1) a lane keeps the half of its values its bit selects and adds its
    partner's copy of that half. Returns ``[V]``: lane l's V/32 sums are
    values ``[l * V/32, (l + 1) * V/32)``."""
    lanes = torch.arange(32)
    half = v.shape[1] // 2
    for o in (16, 8, 4, 2, 1):
        upper = ((lanes & o) != 0)[:, None]
        keep = torch.where(upper, v[:, half:2 * half], v[:, :half])
        recv = torch.where(upper, v[lanes ^ o, half:2 * half],
                           v[lanes ^ o, :half])
        v = keep + recv
        half //= 2
    return v.reshape(-1)


def _kernel_order_grad(x, y, packed, F, H, K, threads=512):
    """Loss and gradient of one batch as the fused K1 kernel forms them:
    each row's terms from the written-out backward (dlogits, ReLU mask,
    x (x) dh, h (x) dz), padded to V = 64 values and to ``threads`` rows,
    folded a warp at a time, then the warps summed in order."""
    B = x.shape[0]
    w1, b1, w2, b2 = (t[0] for t in _unpack(packed, F, H, K))
    inv_b = torch.tensor(1.0, dtype=torch.float32) / B
    h = torch.relu(x @ w1 + b1)                                # [B, H]
    z = h @ w2 + b2                                            # [B, K]
    zmax = z.max(-1, keepdim=True).values
    e = torch.exp(z - zmax)
    se = e.sum(-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(y.long(), K).float()
    loss_row = torch.log(se[:, 0]) - ((z * onehot).sum(-1) - zmax[:, 0])
    dz = (e / se - onehot) * inv_b                             # dlogits
    dh = (dz @ w2.T) * (h > 0)                                 # ReLU mask
    terms = torch.cat([(x[:, :, None] * dh[:, None, :]).reshape(B, F * H),
                       dh, (h[:, :, None] * dz[:, None, :]).reshape(B, H * K),
                       dz, loss_row[:, None]], dim=1)          # [B, P + 1]
    V = -(-terms.shape[1] // 32) * 32
    rows = torch.zeros(threads, V)
    rows[:B, :terms.shape[1]] = terms
    total = torch.zeros(V)
    for w in range(threads // 32):
        total = total + _fold_warp(rows[32 * w:32 * (w + 1)])
    P = terms.shape[1] - 1
    return total[P] * inv_b, total[:P]


class TestFusedKernelGradient:
    """The per-row backward the fused K1 kernel computes, summed in its
    thread -> warp -> block order, against autograd and against JAX's
    value_and_grad of the loss ``_local_sgd`` differentiates, at the
    canonical shape (B = 500 rows, a 3 -> 10 -> 2 fnn, SEA-like inputs in
    [0, 10]). Tolerance 1e-6 on values of order 1, scaled by the largest
    |gradient| where that is above 1 (up to ~10 here, where one float32 ulp
    is ~1e-6): float32 sums of 500 rows in other orders."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_autograd_and_jax(self, seed):
        from feddrift_tpu.core.functional import cross_entropy
        from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
        F, Hd, K, Bn = 3, 10, 2, 500
        rng = np.random.default_rng(seed)
        x = rng.uniform(0, 10, (Bn, F)).astype(np.float32)
        y = (x[:, 0] + x[:, 1] > 8).astype(np.int32)
        jm = JFnn(num_classes=K, hidden_dim=Hd)
        jp = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, F)))["params"]
        jloss, jgrad = jax.value_and_grad(
            lambda p: cross_entropy(jm.apply({"params": p}, jnp.asarray(x)),
                                    jnp.asarray(y)))(jp)
        mod = FeedForwardNN((F,), num_classes=K, hidden_dim=Hd)
        packed = _pack(mod, jax.tree_util.tree_map(lambda a: a[None], jp))
        loss, grad = _kernel_order_grad(torch.from_numpy(x),
                                        torch.from_numpy(y), packed, F, Hd, K)
        want = _pack(mod, jax.tree_util.tree_map(lambda a: a[None],
                                                 jgrad))[0]
        tol = 1e-6 * max(1.0, float(want.abs().max()))
        _close(loss, jloss, atol=1e-6)
        _close(grad, want, atol=tol)
        pg = packed[0].clone().requires_grad_(True)
        w1, b1, w2, b2 = _unpack(pg, F, Hd, K)
        logits = torch.relu(torch.from_numpy(x) @ w1 + b1) @ w2 + b2
        ref = torch.nn.functional.cross_entropy(logits,
                                                torch.from_numpy(y).long())
        ref_grad, = torch.autograd.grad(ref, pg)
        _close(loss, ref.detach(), atol=1e-6)
        _close(grad, ref_grad, atol=tol)
        assert grad.abs().max() > 1e-3         # a gradient, not all zeros


# ----------------------------------------------------------------------
# Weighted sampling (KUE's Poisson bootstrap): K4's rows, K1's gather
# route and feature masks, against the reference's weighted _local_sgd.

def _jax_weighted_uniforms(key, num_steps=S, B=B):
    """The uniforms the reference's ``inverse_cdf_draw`` draws in one round:
    ``split(key, M·C)`` -> ``split(k, S)`` -> ``split(k)`` into k1, k2 ->
    ``uniform(k1, (B,))``; ``[M, C, S, B]``."""
    keys = jax.random.split(key, M * C).reshape(M, C, 2)

    def pair(k):
        def one(kk):
            k1, _ = jax.random.split(kk)
            return jax.random.uniform(k1, (B,))
        return jax.vmap(one)(jax.random.split(k, num_steps))
    u = jax.vmap(jax.vmap(pair))(keys)
    return torch.from_numpy(np.array(u, np.float32))


def _weighted_inputs(seed):
    """Poisson(1) sample weights and 0/1 feature masks (one feature on at
    least) for every model, as KUE hands them over."""
    rng = np.random.default_rng(seed + 200)
    sw = rng.poisson(1.0, (M, C, N)).astype(np.float32)
    fm = (rng.random((M, 3)) < 0.5).astype(np.float32)
    fm[np.arange(M), rng.integers(0, 3, M)] = 1.0
    return sw, fm


def _jax_weighted_step(seed):
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    jm, jp, _ = _jax_setup(seed=seed)
    jstep = JStep(lambda p, x: jm.apply({"params": p}, x),
                  make_optimizer("adam", LR, WD), B, S, 2,
                  weighted_sampling=True)
    return jm, jp, jstep


class TestWeightedRound:
    """One weighted round with feature masks (and a client mask), the
    reference's uniforms injected (parity level 2): params, optimizer state
    and losses at ATOL, nu at NU_RTOL, n exactly. The rows themselves are
    K4's function of integer weights, so they are the reference's bit for
    bit (``test_torch_weighted_draw.py``)."""

    @pytest.mark.parametrize("sampled", [None, (0, 1, 3)])
    def test_round_matches_reference(self, sampled):
        x, y = _data(8)
        tw = _time_w(8)
        sw, fm = _weighted_inputs(8)
        jm, jp, jstep = _jax_weighted_step(8)
        key = jax.random.PRNGKey(31)
        mask = None
        if sampled is not None:
            mask = np.zeros(C, np.float32)
            mask[list(sampled)] = 1.0
        jout = jstep.train_round(
            jp, jstep.init_opt_states(jp, M, C), key, jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(tw), jnp.asarray(sw), jnp.asarray(fm),
            jnp.float32(1.0), None if mask is None else jnp.asarray(mask),
            with_agg_stats=True)
        mod = _module()
        step = TrainStep(mod, B, S, 2, lr=LR, wd=WD, device="cpu",
                         weighted_sampling=True)
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")
        newp, opt, client, n, losses, stats = step.train_round(
            params, step.init_opt_states(params, M, C), torch.from_numpy(x),
            torch.from_numpy(y), torch.from_numpy(tw), 1.0,
            None if mask is None else torch.from_numpy(mask),
            sample_w=torch.from_numpy(sw), feat_mask=torch.from_numpy(fm),
            draws=_jax_weighted_uniforms(key), with_agg_stats=True)
        jnewp, jopt, jclient, jn, jloss, jstats, _ = jout
        _close(mod.pack(newp), _pack(mod, jnewp))
        _close(mod.pack(client), _pack(mod, jclient))
        want = _opt_to_port(mod, jopt)
        _close(opt["mu"], want["mu"])
        for k in ("nu", "nu_max"):
            _close(opt[k], want[k], atol=0, rtol=NU_RTOL)
        assert torch.equal(opt["count"], want["count"])
        _close(n, jn, atol=0)
        _close(losses, jloss)
        _close(stats, jstats, atol=0)

    def test_feature_mask_reaches_the_eval_matrices(self):
        """acc_matrix and acc_cells with per-model feature masks against the
        reference's."""
        x, y = _data(9)
        _, fm = _weighted_inputs(9)
        jm, jp, jstep = _jax_setup(seed=9)
        mod = _module()
        step = TrainStep(mod, B, S, 2, device="cpu")
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")
        got = step.acc_matrix(params, torch.from_numpy(x[:, 1]),
                              torch.from_numpy(y[:, 1]), torch.from_numpy(fm))
        want = jstep.acc_matrix(jp, jnp.asarray(x[:, 1]), jnp.asarray(y[:, 1]),
                                jnp.asarray(fm))
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        _close(got[1], want[1], atol=1e-4)
        cells = step.acc_cells(params, torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(fm))
        jcells = jstep.acc_cells(jp, jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(fm))
        assert np.array_equal(cells.numpy(), np.asarray(jcells))
        plain = step.acc_matrix(params, torch.from_numpy(x[:, 1]),
                                torch.from_numpy(y[:, 1]))
        assert not torch.equal(plain[1], got[1])     # the mask did something

    def test_fused_iteration_matches_reference(self):
        """R weighted rounds through ``train_iteration_eval``, the
        reference's fold_in(iter_key, r) uniforms injected."""
        R, freq, t = 4, 2, 1
        x, y = _data(10)
        tw = _time_w(10)
        sw, fm = _weighted_inputs(10)
        jm, jp, jstep = _jax_weighted_step(10)
        jp = jax.tree_util.tree_map(np.asarray, jp)
        it_key = jax.random.PRNGKey(41)
        jout = jstep.train_iteration_eval(
            jax.tree_util.tree_map(jnp.asarray, jp),
            jstep.init_opt_states(jp, M, C), it_key, jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(tw), jnp.asarray(sw), jnp.asarray(fm),
            jnp.float32(1.0), R, freq, jnp.int32(t))
        u = torch.stack([_jax_weighted_uniforms(jax.random.fold_in(it_key, r))
                         for r in range(R)])
        mod = _module()
        step = TrainStep(mod, B, S, 2, lr=LR, wd=WD, device="cpu",
                         weighted_sampling=True)
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        newp, _, n, losses, bufs, _, _ = step.train_iteration_eval(
            params, step.init_opt_states(params, M, C), torch.from_numpy(x),
            torch.from_numpy(y), torch.from_numpy(tw), 1.0, R, freq, t,
            sample_w=torch.from_numpy(sw), feat_mask=torch.from_numpy(fm),
            draws=u)
        jp2, _, jn, jl, jbufs, _ = jout
        _close(mod.pack(newp), _pack(mod, jp2), atol=1e-5)
        _close(n, jn, atol=0)
        _close(losses, jl, atol=1e-5)
        for got, want in zip(bufs, jbufs):
            if got.dtype == torch.int32:
                assert np.abs(got.numpy() - np.asarray(want)).max() <= 1
            else:
                _close(got, want, atol=1e-3)


def test_kue_fused_and_per_round_paths_are_bitwise_equal():
    """KUE's round inputs (Poisson sample weights, feature masks) through
    the fused loop and through R single rounds from one generator seed:
    each round draws its uniforms in the same order on both paths, so the
    params, optimizer state, n and losses agree bitwise."""
    from feddrift_torch.simulation.runner import Experiment
    cfg = ExperimentConfig(concept_drift_algo="kue", train_iterations=2,
                           comm_round=4, sample_num=60, batch_size=20)
    exp = Experiment(cfg, device="cpu")
    exp.algo.begin_iteration(1)
    tw, sw, fm, lr_scale = exp.algo.round_inputs(1, 0)
    assert sw is not None and fm is not None and exp.step.weighted_sampling
    step, M_, C_ = exp.step, exp.pool.num_models, exp.C_
    opt0 = step.init_opt_states(exp.pool.params, M_, C_)
    step.generator.manual_seed(5)
    fused = step.train_iteration_eval(
        exp.pool.params, {k: v.clone() for k, v in opt0.items()}, exp.x,
        exp.y, tw, lr_scale, 4, 2, 1, sample_w=sw, feat_mask=fm)
    step.generator.manual_seed(5)
    params, opt = exp.pool.params, {k: v.clone() for k, v in opt0.items()}
    for _ in range(4):
        params, opt, _, n, losses = step.train_round(
            params, opt, exp.x, exp.y, tw, lr_scale, sample_w=sw,
            feat_mask=fm)
    assert all(torch.equal(fused[0][k], params[k]) for k in params)
    assert all(torch.equal(fused[1][k], opt[k]) for k in opt)
    assert torch.equal(fused[2], n) and torch.equal(fused[3], losses)


class TestStepCdf:
    """The weighted draw's cdf is computed once a time step: ``TrainStep``
    keeps it while the caller passes the same, unchanged ``time_w`` and
    ``sample_w``, and computes it again for an in-place change or new
    tensors. A client mask does not reach it."""

    def _step(self, monkeypatch):
        import feddrift_torch.core.step as step_mod
        calls, plain = [], step_mod.weighted_cdf

        def counted(tw, sw, **kw):
            calls.append(1)
            return plain(tw, sw, **kw)
        monkeypatch.setattr(step_mod, "weighted_cdf", counted)
        step = TrainStep(_module(), B, S, 2, lr=LR, wd=WD, device="cpu",
                         weighted_sampling=True)
        return step, calls

    def _inputs(self, seed=12):
        x, y = _data(seed)
        sw, fm = _weighted_inputs(seed)
        mod = _module()
        params = mod.unpack(torch.stack(
            [mod.pack(mod.init_params(torch.Generator().manual_seed(m), "cpu"))
             for m in range(M)]))
        return (params, torch.from_numpy(x), torch.from_numpy(y),
                torch.from_numpy(_time_w(seed)), torch.from_numpy(sw),
                torch.from_numpy(fm))

    def test_once_for_the_rounds_of_a_step(self, monkeypatch):
        step, calls = self._step(monkeypatch)
        params, x, y, tw, sw, fm = self._inputs()
        opt = step.init_opt_states(params, M, C)
        mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
        step.generator.manual_seed(3)
        for r in range(5):
            params, opt, *_ = step.train_round(
                params, opt, x, y, tw, 1.0, None if r % 2 else mask,
                sample_w=sw, feat_mask=fm)
        assert len(calls) == 1
        sw.mul_(2.0)                         # an in-place change
        step.train_round(params, opt, x, y, tw, 1.0, sample_w=sw,
                         feat_mask=fm)
        assert len(calls) == 2
        step.train_round(params, opt, x, y, tw.clone(), 1.0, sample_w=sw,
                         feat_mask=fm)       # a new time_w
        assert len(calls) == 3
        step.train_round(params, opt, x, y, tw, 1.0, sample_w=sw.clone(),
                         feat_mask=fm)       # a new sample_w
        assert len(calls) == 4
        step.train_iteration_eval(params, opt, x, y, tw, 1.0, 3, 2, 1,
                                  sample_w=sw, feat_mask=fm)
        assert len(calls) == 5               # the step's tensors again: kept
        step.train_iteration_eval(params, opt, x, y, tw, 1.0, 3, 2, 1,
                                  sample_w=sw, feat_mask=fm)
        assert len(calls) == 5

    def test_kept_cdf_draws_what_a_fresh_one_draws(self, monkeypatch):
        """Rounds on the kept cdf give bitwise what a step whose cdf is
        computed afresh every round gives, with and without a mask."""
        params, x, y, tw, sw, fm = self._inputs(13)
        outs = []
        for fresh in (False, True):
            step = TrainStep(_module(), B, S, 2, lr=LR, wd=WD, device="cpu",
                             weighted_sampling=True)
            p, opt = params, step.init_opt_states(params, M, C)
            step.generator.manual_seed(4)
            for r in range(4):
                if fresh:
                    step._cdf_key = None
                p, opt, _, n, losses = step.train_round(
                    p, opt, x, y, tw, 1.0,
                    torch.tensor([0.0, 1.0, 1.0, 1.0]) if r % 2 else None,
                    sample_w=sw, feat_mask=fm)
            outs.append((p, opt, n, losses))
        (p0, o0, n0, l0), (p1, o1, n1, l1) = outs
        assert all(torch.equal(p0[k], p1[k]) for k in p0)
        assert all(torch.equal(o0[k], o1[k]) for k in o0)
        assert torch.equal(n0, n1) and torch.equal(l0, l1)


def test_kue_fused_and_per_round_paths_are_bitwise_equal_under_sampling():
    """KUE's round inputs under 4-of-10 client sampling: the fused loop
    (one cdf for the step, each round's mask in its total weights) and R
    single rounds with the same masks agree bitwise, and a left-out client
    reports n = 0."""
    from feddrift_torch.simulation.runner import Experiment
    cfg = ExperimentConfig(concept_drift_algo="kue", train_iterations=2,
                           comm_round=4, sample_num=60, batch_size=20,
                           client_num_per_round=4)
    exp = Experiment(cfg, device="cpu")
    exp.algo.begin_iteration(1)
    tw, sw, fm, lr_scale = exp.algo.round_inputs(1, 0)
    masks = exp._device_masks(4)
    assert masks is not None and (masks.sum(1) == 4).all()
    step, M_, C_ = exp.step, exp.pool.num_models, exp.C_
    opt0 = step.init_opt_states(exp.pool.params, M_, C_)
    step.generator.manual_seed(6)
    fused = step.train_iteration_eval(
        exp.pool.params, {k: v.clone() for k, v in opt0.items()}, exp.x,
        exp.y, tw, lr_scale, 4, 2, 1, masks, sample_w=sw, feat_mask=fm)
    step.generator.manual_seed(6)
    params, opt = exp.pool.params, {k: v.clone() for k, v in opt0.items()}
    for r in range(4):
        params, opt, _, n, losses = step.train_round(
            params, opt, exp.x, exp.y, tw, lr_scale, masks[r], sample_w=sw,
            feat_mask=fm)
    assert all(torch.equal(fused[0][k], params[k]) for k in params)
    assert all(torch.equal(fused[1][k], opt[k]) for k in opt)
    assert torch.equal(fused[2], n) and torch.equal(fused[3], losses)
    assert (n[:, masks[3] == 0] == 0).all()
