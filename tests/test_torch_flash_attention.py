"""The port's flash attention against the JAX reference.

On the CPU the wrapper runs its plain version; that is held against the
Pallas kernel in interpret mode and against both packages' blockwise
attention, on the same seeded numpy inputs (atol 1e-5: f32, different
summation orders). The kernel's arithmetic, 3xTF32 tensor-core products,
is emulated on the CPU with the operands cut to TF32 as the tensor core
reads them, and its launch geometry is pinned here. The ``gpu`` cases launch the CUDA kernel and hold
it against the plain version on the card; they import no JAX, so they run
there with ``python -m pytest --noconftest -m gpu`` on this file.
"""

import math

import numpy as np
import pytest
import torch

from feddrift_torch.kernels.flash_attention import (HEAD_DIMS, MAX_GRID_X,
                                                    MAX_GRID_Y,
                                                    _launch_config,
                                                    flash_attention,
                                                    flash_attention_ref)
from feddrift_torch.parallel.ring_attention import blockwise_attention
from torch_threads import one_intra_op_thread  # noqa: F401

ATOL = 1e-5


def _qkv(B=2, H=2, L=64, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, L, D)).astype(np.float32)
                 for _ in range(3))


def _jax_flash(q, k, v, causal, block):
    from feddrift_tpu.parallel.pallas_attention import flash_attention as jf
    return np.asarray(jf(q, k, v, causal, block, block, True))


def _jax_blockwise(q, k, v, causal, block):
    from feddrift_tpu.parallel.ring_attention import blockwise_attention as jb
    return np.asarray(jb(q, k, v, causal=causal, block_size=block))


def _qkv_split(B=2, H=2, L=24, D=8, seed=0, device="cpu"):
    """q, k, v as the transformer makes them: [B, H, L, D] views split off
    one [B, L, 3E] projection, with L stride 3E."""
    E = H * D
    qkv = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, L, 3 * E)).astype(np.float32)).to(device)
    return tuple(t.view(B, L, H, D).transpose(1, 2)
                 for t in qkv.split(E, dim=-1))


def _tf32(x):
    """A float32 operand as the tensor core reads it in TF32: the top 19
    bits (sign, exponent, 10 mantissa bits), the low 13 cleared. The
    kernel's split, big = _tf32(x), is the same bit mask."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, terms):
    """a @ b on TF32 tensor cores: one term (the operands as they are) or
    the kernel's three (small * big + big * small + big * big, with
    small = x - big exact in float32). TF32 products are exact in float32,
    so float32 matmuls of the parts as the tensor core reads them emulate
    them."""
    a_big, b_big = _tf32(a), _tf32(b)
    if terms == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _emulated_kernel(q, k, v, causal, terms):
    L, D = q.shape[-2:]
    s = _tf32_matmul(q * np.float32(1.0 / math.sqrt(D)),
                     np.swapaxes(k, -1, -2), terms)
    if causal:
        s = np.where(np.arange(L)[None, :] > np.arange(L)[:, None],
                     np.float32(-1e30), s)
    p = np.exp(s - s.max(-1, keepdims=True))
    return _tf32_matmul(p, v, terms) / p.sum(-1, keepdims=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class TestPlainVersusJax:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("L", [64, 100])
    def test_matches_pallas_and_blockwise(self, causal, L):
        q, k, v = _qkv(L=L)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        out = flash_attention(tq, tk, tv, causal).numpy()
        np.testing.assert_allclose(out, _jax_flash(q, k, v, causal, 32),
                                   atol=ATOL)
        np.testing.assert_allclose(out, _jax_blockwise(q, k, v, causal, 32),
                                   atol=ATOL)
        port_blk = blockwise_attention(tq, tk, tv, causal=causal,
                                       block_size=32).numpy()
        np.testing.assert_allclose(port_blk, out, atol=ATOL)

    def test_small_blocks(self):
        q, k, v = _qkv(B=1, H=1, L=24, D=8, seed=2)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        out = flash_attention(tq, tk, tv, True).numpy()
        np.testing.assert_allclose(out, _jax_flash(q, k, v, True, 16),
                                   atol=ATOL)
        np.testing.assert_allclose(
            blockwise_attention(tq, tk, tv, causal=True,
                                block_size=16).numpy(), out, atol=ATOL)


class TestWrapper:
    def test_cpu_uses_plain_version_and_counts_no_launch(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(L=40, seed=3))
        before = flash_attention.launches
        out = flash_attention(q, k, v, True)
        assert flash_attention.launches == before
        assert torch.equal(out, flash_attention_ref(q, k, v, True))

    def test_gradient_refusal_condition(self):
        """The card refuses a call that needs gradients (the kernel has no
        backward); the CPU path stays differentiable."""
        from feddrift_torch.kernels._checks import needs_grad
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 8, 8))
        assert not needs_grad(q, k, v)
        kg = k.clone().requires_grad_(True)
        assert needs_grad(q, kg, v)
        with torch.no_grad():
            assert not needs_grad(q, kg, v)
        out = flash_attention(q, kg, v, True)
        out.sum().backward()
        assert kg.grad is not None and kg.grad.abs().sum() > 0

    def test_rejects_bad_inputs(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(L=16, seed=4))
        with pytest.raises(TypeError):
            flash_attention(q.double(), k.double(), v.double())
        with pytest.raises(ValueError):
            flash_attention(q, k[:, :, :8], v)
        with pytest.raises(ValueError):
            flash_attention(q[0], k[0], v[0])

    def test_strided_views_match_contiguous_copies(self):
        q, k, v = _qkv_split(B=3, H=2, L=24, D=8, seed=7)
        assert not q.is_contiguous() and q.stride(2) == 3 * 2 * 8
        out = flash_attention(q, k, v, True)
        same = flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), True)
        np.testing.assert_allclose(out.numpy(), same.numpy(), atol=1e-6)


class TestTensorCoreArithmetic:
    @pytest.mark.parametrize("shape", [(32, 4, 80, 32), (2, 2, 130, 128)])
    def test_three_tf32_terms_hold_atol_and_one_does_not(self, shape):
        # why the kernel splits each operand: one TF32 product keeps 10
        # mantissa bits (~1e-3 off); three terms stay near float32
        q, k, v = _qkv(*shape, seed=6)
        ref = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  True).numpy()
        err3 = np.abs(_emulated_kernel(q, k, v, True, 3) - ref).max()
        err1 = np.abs(_emulated_kernel(q, k, v, True, 1) - ref).max()
        assert err3 <= ATOL < err1

    def test_split_is_exact_and_big_keeps_ten_mantissa_bits(self):
        one = np.float32(1.0)
        ulp = np.float32(2.0 ** -10)          # TF32 spacing at 1.0
        x = np.array([one, one + ulp / 2, one + ulp * 3 / 4, -(one + ulp / 2),
                      one + ulp * 5 / 4], np.float32)
        big = _tf32(x)
        np.testing.assert_array_equal(
            big, np.array([one, one, one, -one, one + ulp], np.float32))
        np.testing.assert_array_equal(big + (x - big), x)
        rng = np.random.default_rng(11)
        y = rng.standard_normal(1000).astype(np.float32)
        small = y - _tf32(y)
        assert np.all(np.abs(small) <= np.abs(y) * 2.0 ** -10)
        # what the tensor core drops of small: at most 2**-20 of |y|
        assert np.all(np.abs(small - _tf32(small)) <= np.abs(y) * 2.0 ** -20)


class TestLaunchConfig:
    @pytest.mark.parametrize("D", HEAD_DIMS)
    @pytest.mark.parametrize("L", [1, 16, 17, 33, 80, 2048])
    def test_depends_on_L_and_D_only(self, L, D):
        cfgs = {(B, H): _launch_config(B, H, L, D)
                for B in (1, 7, 32) for H in (1, 4, 8)}
        first = cfgs[1, 1]
        for (B, H), cfg in cfgs.items():
            assert cfg._replace(grid=None) == first._replace(grid=None)
            assert cfg.grid == (B * H, first.grid[1])
        block_q = 16 * first.warps
        assert first.warps in (1, 2, 4)
        assert first.grid[1] * block_q >= L > (first.grid[1] - 1) * block_q
        assert first.block_k == (32 if D == 128 else 64)

    def test_grid_fits_the_card_beyond_65535_heads(self):
        cfg = _launch_config(70000, 1, 8, 8)
        assert cfg.grid == (70000, 1)
        assert cfg.grid[0] <= MAX_GRID_X and cfg.grid[1] <= MAX_GRID_Y
        assert _launch_config(4, 8, 2048, 64).grid == (32, 32)


@pytest.mark.gpu
class TestKernelOnCard:
    @pytest.mark.parametrize("shape,causal", [
        ((32, 4, 80, 32), True), ((2, 2, 100, 8), False),
        ((1, 1, 24, 8), True), ((2, 3, 50, 16), False),
        ((2, 2, 130, 128), True), ((1, 2, 7, 64), False),
        ((8, 4, 80, 32), True), ((4, 8, 2048, 64), True),
        ((1, 1, 1, 8), True), ((70000, 1, 8, 8), False),
        ((1, 2, 8192, 64), True)])
    def test_kernel_matches_plain(self, cuda, shape, causal):
        q, k, v = (torch.from_numpy(a).to(cuda)
                   for a in _qkv(*shape, seed=5))
        before = flash_attention.launches
        out = flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert out.transpose(1, 2).is_contiguous()     # a [B, L, H, D] buffer
        ref = flash_attention_ref(q, k, v, causal)
        assert (out - ref).abs().max().item() <= ATOL

    @pytest.mark.parametrize("D", HEAD_DIMS)
    def test_strided_qkv_views(self, cuda, D):
        q, k, v = _qkv_split(B=4, H=3, L=70, D=D, seed=9, device=cuda)
        assert not q.is_contiguous()
        out = flash_attention(q, k, v, True)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, True)
        assert (out - ref).abs().max().item() <= ATOL
        assert torch.equal(out, flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), True))

    @pytest.mark.parametrize("D", [32, 128])
    def test_row_is_bitwise_the_same_in_any_batch(self, cuda, D):
        q, k, v = (torch.from_numpy(a).to(cuda)
                   for a in _qkv(32, 4, 80, D, seed=10))
        full = flash_attention(q, k, v, True)
        for b in (0, 13, 31):
            one = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], True)
            assert torch.equal(one[0], full[b])

    def test_kernel_refuses_what_it_does_not_take(self, cuda):
        q = torch.zeros((1, 1, 16, 8), device=cuda)
        strided = torch.zeros((1, 1, 8, 16), device=cuda).transpose(2, 3)
        assert strided.shape == q.shape and not strided.is_contiguous()
        with pytest.raises(ValueError):
            flash_attention(strided, q, q)
        with pytest.raises(ValueError):
            w = torch.zeros((1, 1, 16, 24), device=cuda)
            flash_attention(w, w, w)
        assert 24 not in HEAD_DIMS
        with pytest.raises(TypeError):       # no plain fallback on the card
            flash_attention(q.double(), q.double(), q.double())

    def test_kernel_refuses_gradients(self, cuda):
        q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(1, 2, 16, 8))
        before = flash_attention.launches
        for i in range(3):
            args = [q, k, v]
            args[i] = args[i].clone().requires_grad_(True)
            with pytest.raises(RuntimeError, match="no backward"):
                flash_attention(*args, True)
            with torch.no_grad():
                flash_attention(*args, True)
        assert flash_attention.launches == before + 3

    def test_transformer_goes_through_the_kernel(self, cuda):
        from feddrift_torch.models.transformer import TransformerLM
        kw = dict(vocab_size=90, d_model=128, num_heads=4, num_layers=2,
                  max_len=128)
        model = TransformerLM(**kw)
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device=cuda)
        rows = {k: p[None].expand(4, *p.shape) for k, p in params.items()}
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, 90, size=(4, 80)).astype(np.int32)).to(cuda)
        before = flash_attention.launches
        with torch.no_grad():
            out = model(rows, x)
            assert flash_attention.launches == before + 2   # one per layer
            ref = TransformerLM(**kw, attention_impl="blockwise")(rows, x)
        assert (out - ref).abs().max().item() <= 1e-4
