"""The port's TransformerLM against the flax reference.

The JAX model runs with ``attention_impl="blockwise"`` (its CPU path); its
parameters cross over through ``params_from_jax``, so both packages compute
with the same numbers on the same seeded numpy tokens. Tolerances: atol
1e-5 at the small size, 1e-4 at the registry's full width (float32, two
layers of 128-wide matmuls summed in different orders). Initialisation uses
different generators in the two packages, so it is tested by distribution.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddrift_torch.convert import params_from_jax
from feddrift_torch.core.pool import ModelPool
from feddrift_torch.models.transformer import (ATTENTION_IMPLS,
                                               MultiHeadAttention,
                                               TransformerLM)
from torch_threads import one_intra_op_thread  # noqa: F401

SMALL = dict(vocab_size=50, d_model=32, num_heads=2, num_layers=2,
             max_len=32)


def _jax_model(**kw):
    # remat only changes what the backward keeps, not the forward's values
    from feddrift_tpu.models.transformer import TransformerLM as JaxLM
    return JaxLM(attention_impl="blockwise", remat=False, **kw)


def _jax_params(model, L, seed=0):
    p = jax.jit(model.init)(jax.random.PRNGKey(seed),
                            jnp.zeros((1, L), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, p["params"])


@functools.lru_cache(maxsize=None)
def _small_params(L, seed=0):
    return _jax_params(_jax_model(**SMALL), L, seed)


@functools.lru_cache(maxsize=None)
def _jax_case(kw_items, B, L, seed):
    """(params, tokens, reference logits) of one JAX model; cached so the
    parametrised cases share one compile."""
    kw = dict(kw_items)
    jm = _jax_model(**kw)
    jp = _jax_params(jm, L, seed)
    x = _tokens(B, L, kw["vocab_size"], seed + 1)
    return jp, x, _jax_apply(jm, jp, x)


def _jax_apply(model, params, x):
    return np.asarray(jax.jit(model.apply)({"params": params},
                                           jnp.asarray(x)))


def _tokens(B, L, vocab, seed=1):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, L)).astype(np.int32)


def _port_apply(model, params, x):
    pool = ModelPool(module=model, params={}, init_params=params,
                     num_models=1)
    return pool.apply(params, torch.from_numpy(x)).numpy()


def _compare(kw, B, L, atol, impl="auto", seed=0):
    jp, x, ref = _jax_case(tuple(sorted(kw.items())), B, L, seed)
    out = _port_apply(TransformerLM(**kw, attention_impl=impl),
                      params_from_jax(jp, device="cpu"), x)
    assert out.shape == ref.shape == (B, kw["vocab_size"])
    np.testing.assert_allclose(out, ref, atol=atol)
    return out


class TestParityWithJax:
    @pytest.mark.parametrize("impl", ["auto", "flash", "blockwise"])
    def test_small(self, impl):
        _compare(SMALL, B=3, L=24, atol=1e-5, impl=impl)

    @pytest.mark.parametrize("impl", ["auto", "blockwise"])
    def test_registry_attention_width_one_layer(self, impl):
        # the served attention: q, k, v split off one qkv projection as
        # views, 4 heads of 32, L = 80, heads merged without a copy
        kw = dict(vocab_size=90, d_model=128, num_heads=4, num_layers=1,
                  max_len=128)
        _compare(kw, B=3, L=80, atol=1e-5, impl=impl)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_single_layer_and_short_sequence(self, seed):
        _compare(dict(SMALL, num_layers=1), B=2, L=5, atol=1e-5, seed=seed)

    def test_registry_full_width(self):
        from feddrift_tpu.models import create_model as jax_create
        from feddrift_torch.models import create_model
        ds = _ds()
        jm, tm = jax_create("transformer", ds), create_model("transformer", ds)
        for attr in ("vocab_size", "d_model", "num_heads", "max_len"):
            assert getattr(tm, attr) == getattr(jm, attr)
        assert len(tm.blocks) == jm.num_layers == 2
        assert (tm.vocab_size, tm.d_model, tm.num_heads, tm.max_len) == \
            (90, 128, 4, 128)
        L = ds.feature_shape[0]
        jp = _jax_params(jm, L, seed=3)
        x = ds.x[0, 0, :2]
        ref = _jax_apply(jm, jp, x)
        out = _port_apply(tm, params_from_jax(jp, device="cpu"), x)
        assert out.shape == (2, 90)
        np.testing.assert_allclose(out, ref, atol=1e-4)

    def test_out_of_range_ids_follow_jnp_take(self):
        # negative ids wrap, ids outside [-n, n) give a NaN embedding row
        kw = dict(SMALL, num_layers=1)
        jm = _jax_model(**kw)
        jp = _jax_params(jm, 6)
        x = np.array([[0, 1, -1, -50, 49, 7],
                      [3, 4, 5, 50, 2, 1]], np.int32)
        ref = _jax_apply(jm, jp, x)
        out = _port_apply(TransformerLM(**kw),
                          params_from_jax(jp, device="cpu"), x)
        assert np.isfinite(ref[0]).all() and np.isnan(ref[1]).all()
        np.testing.assert_allclose(out, ref, atol=1e-5)


def _ds():
    from feddrift_tpu.config import ExperimentConfig
    from feddrift_tpu.data.registry import make_dataset
    return make_dataset(ExperimentConfig(dataset="shakespeare",
                                         train_iterations=2, sample_num=2,
                                         data_dir="/nonexistent"))


class TestConvert:
    def test_tree_names_and_shapes(self):
        jp = _small_params(8)
        flat = params_from_jax(jp, device="cpu")
        spec = TransformerLM(**SMALL).param_specs()
        assert set(flat) == set(spec)
        for k, (shape, _) in spec.items():
            assert tuple(flat[k].shape) == shape, k
            assert flat[k].dtype == torch.float32
        for name in ("block_1/MultiHeadAttention_0/qkv/kernel",
                     "block_0/MultiHeadAttention_0/proj/kernel",
                     "block_0/LayerNorm_1/scale", "block_1/Dense_0/bias",
                     "tok_embed/embedding", "pos_embed/embedding",
                     "lm_head/kernel", "LayerNorm_0/bias"):
            assert name in flat

    def test_stacked_pool_tree_converts_and_copies(self):
        jp = _small_params(8)
        stacked = jax.tree_util.tree_map(lambda a: np.stack([a, a + 1]), jp)
        flat = params_from_jax(stacked, device="cpu")
        k = "block_0/Dense_0/kernel"
        assert flat[k].shape == (2, 32, 128)
        np.testing.assert_array_equal(flat[k][1].numpy(),
                                      jp["block_0"]["Dense_0"]["kernel"] + 1)
        flat[k].zero_()        # a copy: the numpy tree is untouched
        assert np.abs(stacked["block_0"]["Dense_0"]["kernel"]).sum() > 0


class TestInit:
    def test_distributions_match_flax(self):
        kw = dict(vocab_size=90, d_model=128, num_heads=4, num_layers=2,
                  max_len=128)
        tp = TransformerLM(**kw).init_params(torch.Generator().manual_seed(0),
                                             device="cpu")
        jp = params_from_jax(_jax_params(_jax_model(**kw), 8), device="cpu")
        assert set(tp) == set(jp)
        for k, t in tp.items():
            j = jp[k]
            assert t.shape == j.shape and t.dtype == j.dtype, k
            if k.endswith("/bias"):
                assert torch.equal(t, torch.zeros_like(t)), k
            elif k.endswith("/scale"):
                assert torch.equal(t, torch.ones_like(t)), k
            elif k.endswith("/kernel"):
                # lecun_normal: truncated normal, std sqrt(1/fan_in)
                std = math.sqrt(1.0 / t.shape[0])
                bound = 2 * std / 0.87962566103423978
                assert t.abs().max() <= bound * (1 + 1e-6), k
                assert abs(t.std().item() / std - 1) < 0.1, k
                assert abs(j.std().item() / std - 1) < 0.1, k
            else:
                # flax default_embed_init: normal, std sqrt(1/E)
                std = math.sqrt(1.0 / t.shape[1])
                assert abs(t.std().item() / std - 1) < 0.1, k
                assert abs(j.std().item() / std - 1) < 0.1, k
                assert abs(t.mean().item()) < 0.1 * std, k

    def test_pool_identical_and_distinct(self):
        model = TransformerLM(**SMALL)
        x = torch.zeros((1, 8), dtype=torch.int32)
        same = ModelPool.create(model, x, 3, seed=5, device="cpu")
        diff = ModelPool.create(model, x, 3, seed=5, identical=False,
                                device="cpu")
        k = "block_0/Dense_0/kernel"
        assert same.params[k].shape == (3, 32, 128)
        assert torch.equal(same.params[k][0], same.params[k][2])
        assert not torch.equal(diff.params[k][0], diff.params[k][1])
        again = ModelPool.create(model, x, 3, seed=5, identical=False,
                                 device="cpu")
        assert all(torch.equal(diff.params[n], again.params[n])
                   for n in diff.params)

    def test_slot_and_set_slot(self):
        model = TransformerLM(**SMALL)
        pool = ModelPool.create(model, torch.zeros((1, 8), dtype=torch.int32),
                                2, seed=1, identical=False, device="cpu")
        one = {k: v + 1 for k, v in pool.slot(0).items()}
        pool.set_slot(1, one)
        assert all(torch.equal(pool.slot(1)[k], one[k]) for k in one)
        assert pool.num_models == 2


class TestModelErrors:
    def test_unknown_attention_impl(self):
        assert ATTENTION_IMPLS == ("auto", "flash", "blockwise")
        with pytest.raises(ValueError):
            MultiHeadAttention(32, 2, attention_impl="pallas")

    def test_unknown_model_name(self):
        from feddrift_torch.models import create_model
        with pytest.raises(KeyError):
            create_model("no_such_model", None)
