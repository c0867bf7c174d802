"""The per-row Dense (``kernels/dense_rows.py``) of the serving forward.

On the CPU: the route and tiles are pinned and take no batch size (L = 1
the gemv route, L > 1 the 3xTF32 tensor-core route, enough blocks at b8 to
fill the card); the kernel's arithmetic is emulated (3xTF32 products in its
k order, within 1e-5 of a float64 product where one TF32 term is not); the
plain version equals flax's ``nn.Dense`` (the one
``feddrift_tpu/models/transformer.py`` builds its layers from) applied row
by row over per-row params, at every Dense shape of the served transformer
and at two ragged shapes (atol 1e-5: float32 sums of up to 512 products in
other orders); a row's answer is bitwise the same at B = 1 and B = 32; the
transformer's five Dense layers a block pair go through the wrapper.

On the card (``gpu`` marker; ``python -m pytest --noconftest -m gpu
tests/test_torch_dense_rows.py``): the kernel against ``torch.bmm`` /
``baddbmm`` at each serving and ragged shape at B in {1, 5, 8, 31, 32}
(atol 1e-5), every row bitwise equal to its B = 1 call, strided and
unaligned views (bitwise equal to contiguous copies), B up to the grid
limit, what it refuses, and the transformer through it.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feddrift_torch.kernels.dense_rows import (MAX_GRID_X, SMS, LaunchConfig,
                                               _launch_config, dense_rows,
                                               dense_rows_ref, grid_blocks)
from torch_threads import one_intra_op_thread  # noqa: F401

ATOL = 1e-5
# (layer, L, in, out, bias) of the served transformer (shakespeare sizes:
# L 80, d_model 128, MLP 512, vocab 90); lm_head sees the last position
SERVE_SHAPES = (("qkv", 80, 128, 384, False), ("proj", 80, 128, 128, False),
                ("Dense_0", 80, 128, 512, True),
                ("Dense_1", 80, 512, 128, True),
                ("lm_head", 1, 128, 90, True))
IDS = [s[0] for s in SERVE_SHAPES]
MMA_SHAPES = SERVE_SHAPES[:4]
# ragged: L, in and out off every tile; out = 90 gives W rows that are not
# 16-byte aligned (the 4-byte copies), out = 200 aligned ones
EDGE_SHAPES = (("ragged_7x100x90", 7, 100, 90, True),
               ("ragged_17x36x200", 17, 36, 200, False))
ALL_SHAPES = SERVE_SHAPES + EDGE_SHAPES
ALL_IDS = [s[0] for s in ALL_SHAPES]
# the route and tiles each serving layer takes
PINNED = {"qkv": LaunchConfig("mma", 16, 64, 4),
          "proj": LaunchConfig("mma", 16, 32, 4),
          "Dense_0": LaunchConfig("mma", 16, 64, 4),
          "Dense_1": LaunchConfig("mma", 16, 32, 4),
          "lm_head": LaunchConfig("gemv", 1, 64, 8)}
# blocks of a b8 micro-batch at each 80-row layer (the card has 132 SMs)
B8_BLOCKS = {"qkv": 240, "proj": 160, "Dense_0": 320, "Dense_1": 160}
CARD_BATCHES = (1, 5, 8, 31, 32)


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
        assert _launch_config(L, n_in, n_out) == PINNED[layer]

    def test_tiles_divide_into_threads(self):
        """mma: one m16 tile of positions, W and partial rows of TO + 8
        floats (= 8 mod 32: TO a multiple of 32), and a k8 slice of every
        32-deep k tile a warp; gemv: a float2 a lane of one warp's row."""
        for L in (1, 2, 15, 16, 80, 4096):
            for out in (1, 90, 128, 384, 100000):
                cfg = _launch_config(L, 128, out)
                if cfg.route == "mma":
                    assert cfg.tile_l == 16 and cfg.tile_out in (32, 64)
                    assert cfg.warps * 8 == 32
                else:
                    assert cfg == LaunchConfig("gemv", 1, 2 * 32, 8)

    @pytest.mark.parametrize("L", [1, 2, 16, 17, 80, 8192])
    def test_route_follows_the_length(self, L):
        assert _launch_config(L, 128, 90).route == \
            ("gemv" if L == 1 else "mma")

    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", MMA_SHAPES,
                             ids=IDS[:4])
    def test_b8_fills_the_card(self, layer, L, n_in, n_out, bias):
        blocks = grid_blocks(8, L, n_out, _launch_config(L, n_in, n_out))
        assert blocks == B8_BLOCKS[layer] and blocks >= SMS


def _tf32(x):
    """A float32 operand as the tensor core reads it in TF32: the top 19
    bits (sign, exponent, 10 mantissa bits), the low 13 cleared."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_nearest(x):
    """The kernel's split, big: x rounded to the nearest TF32 value (add
    half of the lowest kept bit, then clear the low 13)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, terms):
    """a @ b on TF32 tensor cores: one term (the operands as the tensor
    core reads them) or the kernel's three (small * big + big * small +
    big * big, with big rounded to the nearest TF32 value and small =
    x - big exact in float32, read truncated). TF32 products are exact in
    float32, so float32 matmuls of the parts emulate them."""
    if terms == 1:
        return _tf32(a) @ _tf32(b)
    a_big, b_big = _tf32_nearest(a), _tf32_nearest(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _emulated_mma(x, w, b, terms):
    """The mma route's sums: warp j takes k8 slice j of every 32-deep k
    tile and adds each slice's 3xTF32 product (a fresh tensor-core sum)
    into its running sum in float32; the four partials are added in warp
    order, then the bias."""
    parts = []
    for warp in range(4):
        acc = np.zeros(x.shape[:2] + w.shape[2:], np.float32)
        for k in range(8 * warp, x.shape[-1], 32):
            acc = acc + _tf32_matmul(x[..., k:k + 8], w[:, k:k + 8], terms)
        parts.append(acc)
    y = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    return y if b is None else y + b[:, None, :]


def _emulated_gemv(x, w, b):
    """The gemv route's sums in float32: warp j adds x[k] W[k] over
    k = j, j + 8, ... in order, the eight partials in warp order, then the
    bias."""
    parts = []
    for j in range(8):
        acc = np.zeros((x.shape[0], w.shape[2]), np.float32)
        for k in range(j, x.shape[-1], 8):
            acc = acc + x[:, 0, k, None] * w[:, k]
        parts.append(acc)
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return (y if b is None else y + b)[:, None]


def _float64(x, w, b):
    y = x.astype(np.float64) @ w.astype(np.float64)
    return y if b is None else y + b[:, None, :]


class TestTensorCoreArithmetic:
    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", MMA_SHAPES,
                             ids=IDS[:4])
    def test_three_terms_hold_float32_one_does_not(self, layer, L, n_in,
                                                   n_out, bias):
        x, w, b = _inputs(4, L, n_in, n_out, bias, seed=5)
        want = _float64(x, w, b)
        assert np.abs(_emulated_mma(x, w, b, 3) - want).max() <= ATOL
        assert np.abs(_emulated_mma(x, w, b, 1) - want).max() > ATOL

    def test_gemv_order_holds_float32(self):
        x, w, b = _inputs(4, 1, 128, 90, True, seed=6)
        assert np.abs(_emulated_gemv(x, w, b) - _float64(x, w, b)).max() \
            <= ATOL


class TestPlainVersusFlax:
    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", ALL_SHAPES,
                             ids=ALL_IDS)
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
        assert torch.equal(dense_rows(x, w), dense_rows_ref(x, w))
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


def _row_args(x, w, b, rows):
    return x[rows], w[rows], None if b is None else b[rows]


@pytest.mark.gpu
class TestKernelOnCard:
    @pytest.mark.parametrize("B", CARD_BATCHES)
    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", ALL_SHAPES,
                             ids=ALL_IDS)
    def test_kernel_matches_bmm(self, cuda, B, layer, L, n_in, n_out, bias):
        x, w, b = _torch(*_inputs(B, L, n_in, n_out, bias), device=cuda)
        before = dense_rows.launches
        got = dense_rows(x, w, b)
        torch.cuda.synchronize()
        assert dense_rows.launches == before + 1
        want = torch.bmm(x, w) if b is None \
            else torch.baddbmm(b[:, None, :], x, w)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
        torch.testing.assert_close(got, dense_rows_ref(x, w, b), atol=ATOL,
                                   rtol=0)

    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", ALL_SHAPES,
                             ids=ALL_IDS)
    def test_row_is_bitwise_the_same_in_any_batch(self, cuda, layer, L, n_in,
                                                  n_out, bias):
        x, w, b = _torch(*_inputs(32, L, n_in, n_out, bias, seed=2),
                         device=cuda)
        full = dense_rows(x, w, b)
        for r in range(32):
            one = dense_rows(*_row_args(x, w, b, slice(r, r + 1)))
            assert torch.equal(one[0], full[r]), r
        for B in CARD_BATCHES:
            assert torch.equal(dense_rows(*_row_args(x, w, b, slice(B))),
                               full[:B]), B

    def test_strided_views(self, cuda):
        """Views go in without a copy: the last position of a [B, 80, 128]
        tensor (the lm_head's x), a weight view of a wider tensor, the
        attention output merged from [B, L, H, D] (proj's x), and x and W
        cut from wider tensors so that k and out end inside a 16-byte
        copy."""
        x, w, b = _torch(*_inputs(4, 80, 128, 96, True, seed=3), device=cuda)
        last = x[:, -1:]
        wide = torch.cat([w, w], dim=-1)[..., :96]
        assert not last.is_contiguous() and not wide.is_contiguous()
        torch.testing.assert_close(dense_rows(last, wide, b),
                                   dense_rows_ref(last, wide, b), atol=ATOL,
                                   rtol=0)
        heads = torch.randn(4, 80, 4, 32, device=cuda)     # flash's output
        merged = heads.view(4, 80, 128)
        torch.testing.assert_close(dense_rows(merged, wide, b),
                                   dense_rows_ref(merged, wide, b),
                                   atol=ATOL, rtol=0)
        xs = torch.randn(4, 20, 40, device=cuda)[:, :, :37]
        ws = torch.randn(4, 40, 52, device=cuda)[:, :37, :50]
        got = dense_rows(xs, ws, b[:, :50])
        torch.testing.assert_close(got, dense_rows_ref(xs, ws, b[:, :50]),
                                   atol=ATOL, rtol=0)
        assert torch.equal(got, dense_rows(xs.contiguous(), ws.contiguous(),
                                           b[:, :50].contiguous()))

    @pytest.mark.parametrize("layer,L,n_in,n_out,bias", ALL_SHAPES,
                             ids=ALL_IDS)
    def test_unaligned_views_give_the_same_bits(self, cuda, layer, L, n_in,
                                                n_out, bias):
        """x and W one float off 16-byte alignment take the 4-byte copies
        (the gemv route its scalar loads): same answer, bit for bit."""
        x, w, b = _torch(*_inputs(5, L, n_in, n_out, bias, seed=4),
                         device=cuda)
        x1 = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
        w1 = torch.empty(w.numel() + 1, device=cuda)[1:].view(w.shape)
        x1.copy_(x)
        w1.copy_(w)
        assert x1.data_ptr() % 16 and w1.data_ptr() % 16
        assert torch.equal(dense_rows(x1, w1, b), dense_rows(x, w, b))

    def test_batch_up_to_the_grid_limit(self, cuda):
        """B past 65535 (a one-dimensional grid), on stride-0 views; a grid
        past 2^31 - 1 blocks is refused before anything is allocated."""
        x, w, b = _torch(*_inputs(1, 2, 8, 8, True, seed=5), device=cuda)
        B = 70000
        xe, we, be = x.expand(B, -1, -1), w.expand(B, -1, -1), b.expand(B, -1)
        got = dense_rows(xe, we, be)
        assert got.shape == (B, 2, 8)
        assert torch.equal(got, dense_rows(x, w, b).expand(B, -1, -1))
        huge = MAX_GRID_X + 1
        assert grid_blocks(huge, 2, 8, _launch_config(2, 8, 8)) > MAX_GRID_X
        before = dense_rows.launches
        with pytest.raises(ValueError, match="blocks"):
            dense_rows(x.expand(huge, -1, -1), w.expand(huge, -1, -1),
                       b.expand(huge, -1))
        assert dense_rows.launches == before

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

