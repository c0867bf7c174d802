"""The per-row Dense (``kernels/dense_rows.py``) of the serving forward.

On the CPU: the launch geometry is pinned and takes no batch size; the
plain version equals flax's ``nn.Dense`` (the one
``feddrift_tpu/models/transformer.py`` builds its layers from) applied row
by row over per-row params, at every Dense shape of the served transformer
(atol 1e-5: float32 sums of 128 or 512 products in other orders); a row's
answer is bitwise the same at B = 1 and B = 32; the transformer's five
Dense layers a block pair go through the wrapper.

On the card (``gpu`` marker; ``python -m pytest --noconftest -m gpu
tests/test_torch_dense_rows.py``): the kernel against ``torch.bmm`` at each
serving shape (atol 1e-5), every row bitwise equal to its B = 1 call,
strided views, and what it refuses.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddrift_torch.kernels.dense_rows import (LaunchConfig, _launch_config,
                                               dense_rows, dense_rows_ref)

ATOL = 1e-5
# (layer, L, in, out, bias) of the served transformer (shakespeare sizes:
# L 80, d_model 128, MLP 512, vocab 90); lm_head sees the last position
SERVE_SHAPES = (("qkv", 80, 128, 384, False), ("proj", 80, 128, 128, False),
                ("Dense_0", 80, 128, 512, True),
                ("Dense_1", 80, 512, 128, True),
                ("lm_head", 1, 128, 90, True))
IDS = [s[0] for s in SERVE_SHAPES]


def _inputs(B, L, n_in, n_out, bias, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, n_in)).astype(np.float32)
    w = (rng.standard_normal((B, n_in, n_out)) / np.sqrt(n_in)) \
        .astype(np.float32)
    b = (rng.standard_normal((B, n_out)) * 0.1).astype(np.float32) \
        if bias else None
    return x, w, b


def _torch(*arrays, device="cpu"):
    return tuple(None if a is None else torch.from_numpy(a).to(device)
                 for a in arrays)


class TestLaunchConfig:
    def test_takes_no_batch_size(self):
        assert list(inspect.signature(_launch_config).parameters) == \
            ["L", "in_", "out"]

    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", SERVE_SHAPES, ids=IDS)
    def test_pinned_at_the_serving_shapes(self, layer, L, n_in, n_out, bias):
        want = LaunchConfig(1, 64, 1, 1) if L == 1 \
            else LaunchConfig(16, 64, 4, 4)
        assert _launch_config(L, n_in, n_out) == want

    def test_tiles_divide_into_threads(self):
        for L in (1, 2, 15, 16, 80, 4096):
            cfg = _launch_config(L, 128, 90)
            assert cfg.tile_l % cfg.thread_l == 0
            assert cfg.tile_out % cfg.thread_out == 0
            assert (cfg.tile_l // cfg.thread_l) \
                * (cfg.tile_out // cfg.thread_out) == 64


class TestPlainVersusFlax:
    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", SERVE_SHAPES, ids=IDS)
    def test_matches_flax_dense_per_row(self, layer, L, n_in, n_out, bias):
        from feddrift_tpu.models import transformer as jt
        x, w, b = _inputs(8, L, n_in, n_out, bias)
        dense = jt.nn.Dense(n_out, use_bias=bias)

        def one(kernel, bias_row, xb):
            p = {"kernel": kernel}
            if bias:
                p["bias"] = bias_row
            return dense.apply({"params": p}, xb)
        want = jax.vmap(one)(jnp.asarray(w), jnp.asarray(
            b if bias else np.zeros((8, n_out), np.float32)), jnp.asarray(x))
        got = dense_rows_ref(*_torch(x, w, b))
        assert got.shape == (8, L, n_out)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)

    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", SERVE_SHAPES, ids=IDS)
    def test_row_bitwise_at_b1_and_b32(self, layer, L, n_in, n_out, bias):
        x, w, b = _torch(*_inputs(32, L, n_in, n_out, bias, seed=1))
        full = dense_rows(x, w, b)
        for r in (0, 7, 31):
            one = dense_rows(x[r:r + 1], w[r:r + 1],
                             None if b is None else b[r:r + 1])
            assert torch.equal(one[0], full[r]), r


class TestWrapper:
    def test_cpu_takes_plain_version_and_counts_no_launch(self):
        x, w, b = _torch(*_inputs(3, 5, 16, 24, True))
        before = dense_rows.launches
        assert torch.equal(dense_rows(x, w, b), dense_rows_ref(x, w, b))
        assert torch.equal(dense_rows(x, w), torch.bmm(x, w))
        assert dense_rows.launches == before

    def test_rejects_bad_inputs(self):
        x, w, b = _torch(*_inputs(3, 5, 16, 24, True))
        with pytest.raises(ValueError, match=r"x \[B, L, in\]"):
            dense_rows(x, w[:, :8])
        with pytest.raises(ValueError, match="bias"):
            dense_rows(x, w, b[:, :5])
        with pytest.raises(TypeError, match="float32"):
            dense_rows(x.double(), w.double())
        with pytest.raises(ValueError, match=r"x \[B, L, in\]"):
            dense_rows(x[0], w[0])

    def test_transformer_dense_goes_through_the_wrapper(self, monkeypatch):
        """A 2-layer forward calls it 4 times a block and once for lm_head,
        with the bias handed over (no separate add)."""
        from feddrift_torch.models import transformer
        calls = []

        def counted(x, w, bias=None):
            calls.append((tuple(x.shape), tuple(w.shape), bias is not None))
            return dense_rows(x, w, bias)
        monkeypatch.setattr(transformer, "dense_rows", counted)
        model = transformer.TransformerLM(vocab_size=20, d_model=16,
                                          num_heads=2, num_layers=2,
                                          max_len=8)
        params = {k: v[None].expand(2, *v.shape)
                  for k, v in model.init_params(
                      torch.Generator().manual_seed(0), "cpu").items()}
        tokens = torch.randint(0, 20, (2, 6),
                               generator=torch.Generator().manual_seed(1))
        out = model(params, tokens)
        assert out.shape == (2, 20)
        assert calls == 2 * [((2, 6, 16), (2, 16, 48), False),
                             ((2, 6, 16), (2, 16, 16), False),
                             ((2, 6, 16), (2, 16, 64), True),
                             ((2, 6, 64), (2, 64, 16), True)] \
            + [((2, 1, 16), (2, 16, 20), True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
class TestKernelOnCard:
    @pytest.mark.parametrize("B", [32, 8])
    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", SERVE_SHAPES, ids=IDS)
    def test_kernel_matches_bmm(self, cuda, B, layer, L, n_in, n_out, bias):
        x, w, b = _torch(*_inputs(B, L, n_in, n_out, bias), device=cuda)
        before = dense_rows.launches
        got = dense_rows(x, w, b)
        torch.cuda.synchronize()
        assert dense_rows.launches == before + 1
        torch.testing.assert_close(got, dense_rows_ref(x, w, b), atol=ATOL,
                                   rtol=0)

    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", SERVE_SHAPES, ids=IDS)
    def test_row_is_bitwise_the_same_in_any_batch(self, cuda, layer, L, n_in,
                                                  n_out, bias):
        x, w, b = _torch(*_inputs(32, L, n_in, n_out, bias, seed=2),
                         device=cuda)
        full = dense_rows(x, w, b)
        for r in range(32):
            one = dense_rows(x[r:r + 1], w[r:r + 1],
                             None if b is None else b[r:r + 1])
            assert torch.equal(one[0], full[r]), r
        assert torch.equal(dense_rows(x[:8], w[:8],
                                      None if b is None else b[:8]),
                           full[:8])

    def test_strided_views(self, cuda):
        """The last position of a [B, 80, 128] tensor (row stride 80*128)
        and a weight view of a wider tensor go in without a copy."""
        x, w, b = _torch(*_inputs(4, 80, 128, 96, True, seed=3), device=cuda)
        last = x[:, -1:]
        wide = torch.cat([w, w], dim=-1)[..., :96]
        assert not last.is_contiguous() and not wide.is_contiguous()
        torch.testing.assert_close(dense_rows(last, wide, b),
                                   dense_rows_ref(last, wide, b), atol=ATOL,
                                   rtol=0)

    def test_refuses_what_it_does_not_take(self, cuda):
        x, w, b = _torch(*_inputs(2, 4, 8, 8, True), device=cuda)
        before = dense_rows.launches
        with pytest.raises(ValueError, match="stride 1"):
            dense_rows(x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
        with pytest.raises(RuntimeError, match="no backward"):
            dense_rows(x, w.clone().requires_grad_(True), b)
        with pytest.raises(ValueError, match="one device"):
            dense_rows(x, w.cpu(), b)
        assert dense_rows.launches == before
        with torch.no_grad():               # the serving path
            dense_rows(x, w.clone().requires_grad_(True), b)
        assert dense_rows.launches == before + 1

    def test_transformer_goes_through_the_kernel(self, cuda):
        from feddrift_torch.models.transformer import TransformerLM
        model = TransformerLM(vocab_size=90, max_len=128)
        gen = torch.Generator().manual_seed(0)
        params = {k: torch.stack([v, v * 0.5]).to(cuda)
                  for k, v in model.init_params(gen, "cpu").items()}
        tokens = torch.randint(0, 90, (2, 80), generator=gen).to(cuda)
        before = dense_rows.launches
        with torch.no_grad():
            out = model(params, tokens)
        torch.cuda.synchronize()
        assert dense_rows.launches == before + 4 * 2 + 1
        with torch.no_grad():
            plain = TransformerLM(vocab_size=90, max_len=128,
                                  attention_impl="blockwise")(
                {k: v.cpu() for k, v in params.items()}, tokens.cpu())
        torch.testing.assert_close(out.cpu(), plain, atol=1e-4, rtol=0)

