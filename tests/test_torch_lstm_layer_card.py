"""The LSTM layer's kernels on the card (``gpu``-marked: they skip without
one; on the card ``python -m pytest --noconftest -m gpu
tests/test_torch_lstm_layer_card.py``). No JAX here: the kernels are held
to their plain versions (``tests/test_torch_lstm_layer.py`` holds those to
flax and ``jax.grad``).

- ``lstm_layer_fwd`` / ``lstm_layer_bwd`` at CharLSTM's width (H 256) on a
  ragged N (37: a last block of 5 rows) and at the other instances' widths,
  both ``sequence`` settings: the kernel's distance from the plain version
  run in float64 within twice the float32 plain version's plus
  ``F64_FLOOR`` (the rule of ``chip_smoke.py``'s layer checks), two calls
  bitwise, one launch a call and no plain call.
- The evals' forward: K 1, N 8192 under ``no_grad``, only h written.
- ``lstm_layer``'s gradients of zx, W_h and b against autograd through the
  plain forward in float64, by the same rule.
- What the kernels refuse raises.
- The per-step route (WordLSTM's width) frees a layer's steps, its
  preallocated outputs included, without the cycle collector.
"""

import gc

import pytest
import torch

from feddrift_torch.kernels.lstm_layer import (lstm_layer, lstm_layer_bwd,
                                               lstm_layer_bwd_ref,
                                               lstm_layer_fwd,
                                               lstm_layer_fwd_ref)
from feddrift_torch.models.base import lstm_specs, pair_lstm

F64_FLOOR = 1e-6
CASES = ((2, 37, 9, 256), (3, 5, 7, 32), (2, 40, 6, 64), (2, 33, 5, 128))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(K, N, L, H, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=gen,
                                  dtype=torch.float64)
    return (rand(K, N, L, 4 * H), rand(K, H, 4 * H) / H ** 0.5,
            rand(K, 4 * H), rand(K, N, L, H))


def _dist(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def _within(kernel, plain32, plain64):
    return _dist(kernel, plain64) <= 2 * _dist(plain32, plain64) + F64_FLOOR


@pytest.mark.gpu
@pytest.mark.parametrize("sequence", [True, False], ids=["seq", "last"])
@pytest.mark.parametrize("K,N,L,H", CASES)
def test_kernels_match_their_plain_versions(cuda, K, N, L, H, sequence):
    zx, wh, b, dH64 = _inputs(K, N, L, H)
    if not sequence:
        dH64 = dH64[:, :, -1].contiguous()
    f32 = [t.float() for t in (zx, wh, b, dH64)]
    launches = lstm_layer_fwd.launches, lstm_layer_bwd.launches
    got = lstm_layer_fwd(*f32[:3])
    dz = lstm_layer_bwd(f32[3], got[2], got[1], f32[1])
    again = lstm_layer_fwd(*f32[:3])
    dz2 = lstm_layer_bwd(f32[3], again[2], again[1], f32[1])
    torch.cuda.synchronize()
    assert (lstm_layer_fwd.launches - launches[0],
            lstm_layer_bwd.launches - launches[1]) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip((*got, dz), (*again, dz2)))
    calls = lstm_layer_fwd_ref.cuda_calls, lstm_layer_bwd_ref.cuda_calls
    p32 = lstm_layer_fwd_ref(*f32[:3])
    d32 = lstm_layer_bwd_ref(f32[3], p32[2], p32[1], f32[1])
    p64 = lstm_layer_fwd_ref(zx, wh, b)
    d64 = lstm_layer_bwd_ref(dH64, p64[2], p64[1], wh)
    assert (lstm_layer_fwd_ref.cuda_calls - calls[0],
            lstm_layer_bwd_ref.cuda_calls - calls[1]) == (2, 2)
    for k, p, q in zip((*got, dz), (*p32, d32), (*p64, d64)):
        assert k.dtype == torch.float32 and k.shape == q.shape
        assert _within(k, p, q)


@pytest.mark.gpu
def test_eval_forward_writes_only_h(cuda):
    K, N, L, H = 1, 8192, 80, 256
    zx, wh, b, _ = _inputs(K, N, L, H, seed=1)
    f32 = [t.float() for t in (zx, wh, b)]
    with torch.no_grad():
        for sequence in (True, False):
            h = lstm_layer(*f32, sequence)
            want = lstm_layer_fwd_ref(*f32, state=False, h_all=sequence)[0]
            want64 = lstm_layer_fwd_ref(zx, wh, b, state=False,
                                        h_all=sequence)[0]
            assert h.shape == want.shape
            assert _within(h, want, want64)
            assert torch.equal(h, lstm_layer(*f32, sequence))


@pytest.mark.gpu
@pytest.mark.parametrize("sequence", [True, False], ids=["seq", "last"])
def test_layer_gradients(cuda, sequence):
    zx, wh, b, dH = _inputs(3, 37, 11, 256, seed=2)
    if not sequence:
        dH = dH[:, :, -1]
    grads = {}
    for key, dt in (("kernel", torch.float32), ("plain", torch.float32),
                    ("f64", torch.float64)):
        ins = [t.to(dt).requires_grad_() for t in (zx, wh, b)]
        if key == "kernel":
            out = lstm_layer(*ins, sequence)
        else:
            h = lstm_layer_fwd_ref(*ins)[0]
            out = h if sequence else h[:, :, -1]
        grads[key] = torch.autograd.grad((out * dH.to(dt)).sum(), ins)
    for k, p, q in zip(grads["kernel"], grads["plain"], grads["f64"]):
        assert _within(k, p, q)


@pytest.mark.gpu
def test_refusals(cuda):
    zx = torch.zeros(2, 3, 4, 4 * 256, device=cuda)
    wh = torch.zeros(2, 256, 4 * 256, device=cuda)
    b = torch.zeros(2, 4 * 256, device=cuda)
    with pytest.raises(ValueError):               # float64
        lstm_layer_fwd(zx.double(), wh.double(), b.double())
    with pytest.raises(ValueError):               # no instance at H 670
        lstm_layer_fwd(torch.zeros(2, 3, 4, 4 * 670, device=cuda),
                       torch.zeros(2, 670, 4 * 670, device=cuda),
                       torch.zeros(2, 4 * 670, device=cuda))
    with pytest.raises(ValueError):               # a strided W_h
        lstm_layer_fwd(zx, wh.mT.contiguous().mT, b)
    with pytest.raises(ValueError):               # W_h of another width
        lstm_layer_fwd(zx, wh[:, :128], b)
    with pytest.raises(ValueError):               # dH of neither shape
        lstm_layer_bwd(torch.zeros(2, 3, 256, 1, device=cuda),
                       torch.zeros_like(zx), torch.zeros(2, 3, 4, 256,
                                                         device=cuda), wh)


@pytest.mark.gpu
def test_per_step_route_frees_its_steps_without_the_cycle_collector(cuda):
    """No reference cycle holds a layer's step outputs: with the cycle
    collector off, a training forward and backward of the per-step route
    leave the allocated memory where it was."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = {key: (0.1 * torch.randn(3, *shape, device=cuda,
                                      generator=gen)).requires_grad_()
              for key, (shape, _) in lstm_specs("cell", 8, 670).items()}
    x = torch.randn(3, 16, 5, 8, device=cuda, generator=gen)
    gc.collect()
    gc.disable()
    try:
        before = torch.cuda.memory_allocated()
        for _ in range(3):
            out = pair_lstm(x, params, "cell", sequence=False)
            torch.autograd.grad(out.sum(), list(params.values()))
            del out
        assert torch.cuda.memory_allocated() == before
    finally:
        gc.enable()
