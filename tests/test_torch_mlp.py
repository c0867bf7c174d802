"""The port's synthetic datasets, fnn and pool edits against the JAX
package on the CPU.

Data is bitwise equal (the same numpy generator path). The fnn's logits and
gradients match flax on converted params at atol 1e-6 (float32, a 3->10->2
MLP, sums in another order). The init is tested by distribution (torch's
generator is not JAX's): 20 000 kernel draws, mean within 0.02 of 0 and std
within 2 % of flax's truncated lecun normal, all within two of its std.
Pool edits (reinit, copy, merge) match the JAX ModelPool exactly, apart
from merge's f32 arithmetic (atol 1e-7).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddrift_torch.config import DEFAULT_DELTAS, ExperimentConfig
from feddrift_torch.convert import params_from_jax, pool_from_jax
from feddrift_torch.core.functional import cross_entropy, tree_select
from feddrift_torch.core.pool import ModelPool
from feddrift_torch.data.registry import make_dataset
from feddrift_torch.models import create_model
from feddrift_torch.models.mlp import FeedForwardNN
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("name,kw", [
    ("sea", {}), ("sine", {"change_points": "W"}),
    ("circle", {"noise_prob": 0.1, "time_stretch": 2, "seed": 3}),
    ("sea", {"change_points": "B", "seed": 2}),
    ("sea", {"change_points": "rand", "seed": 5, "train_iterations": 6})])
def test_datasets_bitwise_equal(name, kw):
    from feddrift_tpu.config import ExperimentConfig as JCfg
    from feddrift_tpu.data.registry import make_dataset as jmake
    args = dict(dataset=name, sample_num=50, **kw)
    ours, ref = make_dataset(ExperimentConfig(**args)), jmake(JCfg(**args))
    for a, b in ((ours.x, ref.x), (ours.y, ref.y),
                 (ours.concepts, ref.concepts)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours.num_classes == ref.num_classes == 2
    assert (ours.num_steps, ours.samples_per_step) == (ref.num_steps, 50)


def _jax_fnn(F=3, K=2, H=10, M=4, seed=0):
    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    jm = JFnn(num_classes=K, hidden_dim=H)
    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    params = jax.vmap(lambda k: jm.init(k, jnp.zeros((1, F)))["params"])(keys)
    return jm, params


def test_registry_builds_the_fnn():
    ds = make_dataset(ExperimentConfig(sample_num=10))
    mod = create_model("fnn", ds, ExperimentConfig(fnn_hidden_dim=7))
    assert isinstance(mod, FeedForwardNN)
    assert (mod.in_dim, mod.hidden_dim, mod.num_classes) == (3, 7, 2)
    assert mod.num_params == 3 * 7 + 7 + 7 * 2 + 2
    with pytest.raises(KeyError):
        create_model("vgg11", ds, None)


class TestForward:
    def test_logits_and_grads_match_flax(self):
        jm, jp = _jax_fnn()
        one = jax.tree_util.tree_map(lambda p: p[1], jp)
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 10, (64, 3)).astype(np.float32)
        y = rng.integers(0, 2, 64).astype(np.int32)
        from feddrift_tpu.core.functional import cross_entropy as jce

        def jloss(p):
            return jce(jm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))
        jl, jg = jax.value_and_grad(jloss)(one)
        mod = FeedForwardNN((3,), 2, 10)
        params = {k: v.requires_grad_(True) for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, one), "cpu").items()}
        logits = mod(params, torch.from_numpy(x))
        np.testing.assert_allclose(
            logits.detach().numpy(),
            np.asarray(jm.apply({"params": one}, jnp.asarray(x))), atol=1e-6)
        loss = cross_entropy(logits, torch.from_numpy(y))
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(jl), abs=1e-6)
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), "cpu")
        for k, p in params.items():
            np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                       atol=1e-6)

    def test_lead_axes_broadcast_and_rows(self):
        mod = FeedForwardNN((3,), 2, 10)
        gen = torch.Generator().manual_seed(0)
        flat = torch.stack([mod.pack(mod.init_params(gen, "cpu"))
                            for _ in range(4)])
        params = mod.unpack(flat)
        x = torch.rand(5, 7, 3)                        # [C, N, F]
        pairs = mod({k: v[:, None] for k, v in params.items()}, x[None])
        assert pairs.shape == (4, 5, 7, 2)
        one = mod({k: v[2] for k, v in params.items()}, x[3])
        assert torch.allclose(pairs[2, 3], one, atol=1e-6)
        # per-row weights (the pool's apply_rows form): no sample axis
        rows = mod({k: v[[2, 0]] for k, v in params.items()}, x[3, :2])
        assert torch.allclose(rows[0], one[0], atol=1e-6)
        assert torch.equal(mod.pack(params), flat)


def test_init_matches_lecun_truncated_normal():
    mod = FeedForwardNN((4,), 2, 5000)
    p = mod.init_params(torch.Generator().manual_seed(1), "cpu")
    k = p["Dense_0/kernel"].flatten()
    scale = math.sqrt(1.0 / 4)
    assert k.numel() == 20000
    assert abs(float(k.mean())) < 0.02 * scale
    # flax: std of the draw = sqrt(1/fan_in) after dividing the truncation
    assert float(k.std()) == pytest.approx(scale, rel=0.02)
    assert float(k.abs().max()) <= 2 * scale / 0.87962566103423978
    assert torch.equal(p["Dense_0/bias"], torch.zeros(5000))
    jm, jp = _jax_fnn(F=4, H=5000, M=1)
    jk = np.asarray(jp["Dense_0"]["kernel"]).ravel()
    assert float(k.std()) == pytest.approx(float(jk.std()), rel=0.03)


class TestPool:
    def _pools(self):
        from feddrift_tpu.core.pool import ModelPool as JPool
        from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
        jpool = JPool.create(JFnn(num_classes=2, hidden_dim=10),
                             jnp.zeros((2, 3)), 4, seed=3, identical=False)
        return jpool, pool_from_jax(jpool, FeedForwardNN((3,), 2, 10), "cpu")

    def _same(self, pool, jpool, atol=0.0):
        want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jpool.params), "cpu")
        for k, v in pool.params.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=atol)

    def test_converted_pool_computes_the_same_logits(self):
        jpool, pool = self._pools()
        x = np.random.default_rng(1).uniform(0, 10, (9, 3)).astype(np.float32)
        for m in range(4):
            want = np.asarray(jpool.apply(jpool.slot(m), jnp.asarray(x)))
            got = pool.module(pool.slot(m), torch.from_numpy(x))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
            rows = pool.apply(pool.slot(m), torch.from_numpy(x))
            np.testing.assert_allclose(rows.numpy(), want, atol=1e-6)

    def test_edits_match_the_reference(self):
        jpool, pool = self._pools()
        for fn, args in (("copy_slot", (2, 0)), ("reinit_slot", (1,)),
                         ("merge_slots", (0, 3, 0.75, 0.25))):
            before = pool.params
            getattr(jpool, fn)(*args)
            getattr(pool, fn)(*args)
            self._same(pool, jpool, atol=1e-7)
            assert pool.params is not before       # rebound, as in JAX
        # merge reinitialised the second slot to the stored init params
        for k, v in pool.params.items():
            assert torch.equal(v[3], pool.init_params[k])

    def test_distinct_reinit_is_fresh_and_seeded(self):
        _, pool = self._pools()
        pool.distinct_reinit_slot(1, seed=7)
        a = {k: v[1].clone() for k, v in pool.params.items()}
        pool.distinct_reinit_slot(1, seed=7)
        assert all(torch.equal(a[k], pool.params[k][1]) for k in a)
        assert not torch.equal(a["Dense_0/kernel"],
                               pool.params["Dense_0/kernel"][0])

    def test_create_identical_slots(self):
        mod = FeedForwardNN((3,), 2, 10)
        pool = ModelPool.create(mod, None, 4, seed=42, device="cpu")
        for k, v in pool.params.items():
            assert all(torch.equal(v[m], pool.init_params[k])
                       for m in range(4))


def test_functional_helpers_match_reference():
    from feddrift_tpu.core.functional import cross_entropy as jce
    from feddrift_tpu.core.functional import tree_select as jsel
    rng = np.random.default_rng(4)
    z = rng.standard_normal((6, 5, 3)).astype(np.float32)
    y = rng.integers(0, 3, (6, 5)).astype(np.int32)
    assert float(cross_entropy(torch.from_numpy(z), torch.from_numpy(y))) \
        == pytest.approx(float(jce(jnp.asarray(z), jnp.asarray(y))), abs=1e-6)
    a = {"w": torch.ones(2)}
    b = {"w": torch.zeros(2)}
    assert torch.equal(tree_select(torch.tensor(False), a, b)["w"], b["w"])
    assert torch.equal(tree_select(True, a, b)["w"],
                       torch.from_numpy(np.array(
                           jsel(True, {"w": jnp.ones(2)},
                                {"w": jnp.zeros(2)})["w"])))


@pytest.mark.parametrize("arg,algo,dataset", [
    ("H_A_C_1_10_0", "softcluster", "sea"), ("H_B_E_2_0_0", "softcluster",
                                             "sine"),
    ("H_A_D_1_0_25", "softcluster", "circle"), ("mmacc_06", "softcluster",
                                                "sea"),
    ("cfl_0.1_win-1", "softcluster", "sea"), ("win-1_iter", "ada", "sea"),
    ("3", "driftsurf", "sine"), ("", "driftsurf", "sea")])
def test_algo_params_parse_as_reference(arg, algo, dataset):
    from feddrift_tpu.config import ExperimentConfig as JCfg
    kw = dict(concept_drift_algo_arg=arg, concept_drift_algo=algo,
              dataset=dataset)
    assert ExperimentConfig(**kw).algo_params() == JCfg(**kw).algo_params()
    assert DEFAULT_DELTAS == __import__(
        "feddrift_tpu.config", fromlist=["DEFAULT_DELTAS"]).DEFAULT_DELTAS


def test_config_matches_reference_defaults_and_refuses_unported_modes():
    import dataclasses
    from feddrift_tpu.config import ExperimentConfig as JCfg
    ref = JCfg()
    for f in dataclasses.fields(ExperimentConfig):
        assert getattr(ExperimentConfig(), f.name) == getattr(ref, f.name), \
            f.name
    for kw in ({"population_size": 20}, {"stream_data": True},
               {"megastep_k": 2}):
        with pytest.raises(NotImplementedError):
            ExperimentConfig(**kw)
    cfg = ExperimentConfig(lr=0.5, seed=3)
    assert json.loads(cfg.to_json()) == dataclasses.asdict(cfg)
