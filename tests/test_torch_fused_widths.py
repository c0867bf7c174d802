"""K1's fused kernel at susy's and ro's widths (18 -> 10 -> 2, P 212, and
5 -> 10 -> 2, P 82), where it folds a row's P + 1 values 32 at a time, with
K2 as its epilogue and K3's eval folded in: the routes and the budget that
decide it on the CPU, the one list of fused widths both kernels read, and
the chunked fold's summation order, emulated in float32 with
``tests/test_torch_train_step.py``'s fold.

The kernels themselves run only on the card (``tests/test_torch_card.py``,
``tests/test_torch_fused_eval.py``, ``chip_smoke.py``); the slice's plain
versions at these widths are held to the JAX package in
``tests/test_torch_tabular.py``.
"""

import importlib
import os
import re

import numpy as np
import pytest
import torch

from feddrift_torch.kernels.eval_cells import MAX_SMEM, _unpack
from feddrift_torch.kernels.local_sgd import (FUSED_WIDTHS, _folds_eval,
                                              _route, fused_smem_bytes,
                                              fused_threads)
from test_torch_train_step import _fold_warp, _kernel_order_grad
from torch_threads import one_intra_op_thread  # noqa: F401

# the modules (the package's attributes of these names are the functions)
k1_module = importlib.import_module("feddrift_torch.kernels.local_sgd")
k3 = importlib.import_module("feddrift_torch.kernels.eval_cells")
SUSY, RO, SEA = (18, 10, 2), (5, 10, 2), (3, 10, 2)
CSRC = os.path.join(os.path.dirname(k1_module.__file__), "csrc")


def _params(F, H, K):
    return F * H + H + H * K + K


@pytest.mark.parametrize("shape", [SUSY, RO], ids=["susy", "ro"])
def test_tabular_widths_route_fused_under_adam_only(shape):
    """Under AMSGrad K1 and K3 both take their fused kernels at B = N =
    500; under SGD K1 keeps the general kernel (the fused one steps
    AMSGrad only), K3 its fused one, and the round folds no eval."""
    assert _route(*shape, 500, "adam") == "fused"
    assert _route(*shape, 500, "sgd") == "general"
    assert k3._route(*shape) == "fused"
    assert _folds_eval(*shape, 500, 500, "adam")
    assert not _folds_eval(*shape, 500, 500, "sgd")


@pytest.mark.parametrize("shape,last_general", [(SUSY, 192), (RO, 64),
                                                (SEA, 0)],
                         ids=["susy", "ro", "sea"])
def test_the_batch_at_which_the_fused_route_starts(shape, last_general):
    """Thread p of the fused kernel's block owns parameter p and thread P
    the loss, so its block (round_up(B, 32), at least 64 threads) must have
    P + 1 threads: susy's 213 from B = 193 on, ro's 83 from B = 65; SEA's
    63 at any batch. Below that the general kernel takes the round."""
    P = _params(*shape)
    for B in range(1, 513):
        want = "fused" if B > last_general else "general"
        assert _route(*shape, B, "adam") == want, B
        assert (fused_threads(B) >= P + 1) == (want == "fused"), B


@pytest.mark.parametrize("shape,stages,mode", [
    (SUSY, 3, "staged"), (RO, 5, "staged"), (SEA, 5, "staged")],
    ids=["susy", "ro", "sea"])
def test_fused_budget_and_eval_mode_at_full_batch(shape, stages, mode):
    """At B = N = 500, S = 5: without an eval the ring holds all five
    steps; with one, susy's ring gives up two stages so that the eval
    window (2N(F + 1) floats, 76 KB) is staged beside it, within a block's
    shared memory. ro and SEA keep five."""
    plain = fused_smem_bytes(*shape, 500, 5)
    assert plain[1:] == (5, "none") and plain[0] <= MAX_SMEM
    got = fused_smem_bytes(*shape, 500, 5, 500, eval_window=True)
    assert got[1:] == (stages, mode) and got[0] <= MAX_SMEM
    # five stages and the window would not fit at susy's width
    F = shape[0]
    window = 8 * 500 * F + 8 * 500
    assert (plain[0] + window > MAX_SMEM) == (shape == SUSY)


def test_fused_budget_reads_the_window_where_it_lies_when_it_cannot_fit():
    """A window of 3000 rows at susy's width (432 KB) fits no ring: the
    ring keeps its stages and the kernel reads the window from device
    memory; a step too wide for eight stages takes fewer."""
    got = fused_smem_bytes(*SUSY, 500, 5, 3000, eval_window=True)
    assert got[1:] == (5, "global") and got[0] <= MAX_SMEM
    eight = fused_smem_bytes(*SUSY, 512, 12)
    assert eight[1] < 8 and eight[0] <= MAX_SMEM
    assert eight[0] + 4 * 512 * (SUSY[0] + 1) > MAX_SMEM   # one stage more


def test_one_list_of_fused_widths():
    """K1 reads K3's list, the two routes agree on every width (each in
    the list fused in both, a neighbour of each in neither), and both CUDA
    entry points dispatch exactly the listed widths."""
    assert k1_module.FUSED_WIDTHS is k3.FUSED_WIDTHS
    assert {SUSY, RO, SEA, (2, 10, 2)} == set(FUSED_WIDTHS)
    for F, H, K in FUSED_WIDTHS:
        assert _route(F, H, K, 500, "adam") == k3._route(F, H, K) == "fused"
        for other in ((F + 1, H, K), (F, H + 1, K), (F, H, K + 1)):
            if other not in FUSED_WIDTHS:
                assert _route(*other, 500, "adam") != "fused"
                assert k3._route(*other) != "fused"
    for src in ("local_sgd.cu", "eval_cells.cu"):
        with open(os.path.join(CSRC, src)) as f:
            text = f.read()
        dispatched = {tuple(map(int, m)) for m in re.findall(
            r"p->F == (\d+) && p->H == (\d+) && p->K == (\d+)\)\s*\n\s*"
            r"ret = launch_fused<\1, \2, \3>", text)}
        assert dispatched == set(FUSED_WIDTHS), src


@pytest.mark.parametrize("shape,chunk", [(SUSY, 32), (RO, 32), (SUSY, 64)],
                         ids=["susy", "ro", "susy_64"])
def test_chunked_fold_sums_bitwise_as_one_pass(shape, chunk):
    """Folding a row's P + 1 values a chunk at a time changes only which
    lane ends with a sum, not the tree it is summed over: each value's sum
    over a warp is bitwise that of the one-pass fold, and so is the sum of
    the warps in order."""
    P = _params(*shape)
    V = -(-(P + 1) // chunk) * chunk
    rng = np.random.default_rng(P + chunk)
    warps = torch.from_numpy(
        (rng.standard_normal((16, 32, V)) * 10.0 ** rng.integers(
            -6, 3, (16, 32, V))).astype(np.float32))
    one = torch.zeros(V)
    chunked = torch.zeros(V)
    for w in range(16):
        one = one + _fold_warp(warps[w])
        chunked = chunked + torch.cat([_fold_warp(warps[w, :, c:c + chunk])
                                       for c in range(0, V, chunk)])
    assert torch.equal(one, chunked)
    assert not torch.equal(one, warps.double().sum((0, 1)).float())


def test_kernel_order_gradient_at_susys_width():
    """The per-row backward at susy's width, summed in the fused kernel's
    order (a row's values folded a warp at a time, bitwise the chunked
    fold by the test above, then the warps in order), against autograd of
    the mean cross-entropy: float32 sums of 500 rows in other orders, 1e-6
    of the largest gradient."""
    F, H, K = SUSY
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((500, F)).astype(np.float32))
    y = torch.from_numpy((rng.random(500) < 0.5).astype(np.int32))
    packed = torch.from_numpy(
        (rng.standard_normal((1, _params(F, H, K))) * 0.3).astype(np.float32))
    loss, grad = _kernel_order_grad(x, y, packed, F, H, K)
    pg = packed[0].clone().requires_grad_(True)
    w1, b1, w2, b2 = _unpack(pg, F, H, K)
    ref = torch.nn.functional.cross_entropy(
        torch.relu(x @ w1 + b1) @ w2 + b2, y.long())
    want, = torch.autograd.grad(ref, pg)
    tol = 1e-6 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(loss, ref.detach(), atol=1e-6, rtol=0)
    torch.testing.assert_close(grad, want, atol=tol, rtol=0)
    assert want.abs().max() > 1e-3
