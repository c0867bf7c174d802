"""The port's flash attention against the JAX reference.

On the CPU the wrapper runs its plain version; that is held against the
Pallas kernel in interpret mode and against both packages' blockwise
attention, on the same seeded numpy inputs (atol 1e-5: f32, different
summation orders). The ``gpu`` cases launch the CUDA kernel and hold it
against the plain version on the card; they import no JAX, so they run
there with ``python -m pytest --noconftest -m gpu`` on this file.
"""

import numpy as np
import pytest
import torch

from feddrift_torch.kernels.flash_attention import (HEAD_DIMS,
                                                    flash_attention,
                                                    flash_attention_ref)
from feddrift_torch.parallel.ring_attention import blockwise_attention

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

    def test_rejects_bad_inputs(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(L=16, seed=4))
        with pytest.raises(TypeError):
            flash_attention(q.double(), k.double(), v.double())
        with pytest.raises(ValueError):
            flash_attention(q, k[:, :, :8], v)
        with pytest.raises(ValueError):
            flash_attention(q[0], k[0], v[0])


@pytest.mark.gpu
class TestKernelOnCard:
    @pytest.mark.parametrize("shape,causal", [
        ((32, 4, 80, 32), True), ((2, 2, 100, 8), False),
        ((1, 1, 24, 8), True), ((2, 3, 50, 16), False),
        ((2, 2, 130, 128), True), ((1, 2, 7, 64), False)])
    def test_kernel_matches_plain(self, cuda, shape, causal):
        q, k, v = (torch.from_numpy(a).to(cuda)
                   for a in _qkv(*shape, seed=5))
        before = flash_attention.launches
        out = flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref = flash_attention_ref(q, k, v, causal)
        assert (out - ref).abs().max().item() <= ATOL

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
