"""K1's and K3's wide kernels (``csrc/local_sgd.cu::local_sgd_wide_kernel``,
``csrc/eval_cells.cu::eval_wide_kernel``): their routes and shared-memory
budgets on the CPU, and the kernels themselves against their plain
versions on the card (``gpu``). The plain versions, ``local_sgd_ref`` and
``eval_cells_ref``, are held to the JAX package in
``tests/test_torch_lr_sgd.py``, ``tests/test_torch_train_step.py`` and
``tests/test_torch_eval_cells.py``.

On the card, under SGD params and losses at atol 1e-5; under AMSGrad the
kernel as far from the plain version in float64 as the float32 plain
version (``chip_smoke.py``'s rule); the eval's counts equal but for rows
whose top two plain outputs lie within 1e-5, NLL sums at rtol 1e-4; two
calls bitwise. Run them there with ``python -m pytest --noconftest -m gpu
tests/test_torch_wide_kernels.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from feddrift_torch.kernels.eval_cells import _unpack, eval_cells, \
    eval_cells_ref
from feddrift_torch.kernels.local_sgd import (FUSED_WIDTHS, init_opt_state,
                                              local_sgd, local_sgd_ref)
from feddrift_torch.models.mlp import FeedForwardNN, LogisticRegression

# the wrapper modules (the package exports their functions under the same
# names)
k1_wrapper = importlib.import_module("feddrift_torch.kernels.local_sgd")
k3 = importlib.import_module("feddrift_torch.kernels.eval_cells")

LR, WD = 0.05, 0.001

# MNIST-4's widths and the unported image datasets' (in, hidden, classes)
MNIST_FNN, MNIST_LR = (784, 10, 10), (784, 0, 10)
FEMNIST_FNN, CIFAR10_FNN, FMOW_FNN = (784, 10, 62), (3072, 10, 10), \
    (3072, 10, 62)


# --------------------------------------------------------------------------
# Routes and budgets

@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("shape", [MNIST_FNN, MNIST_LR])
def test_mnist_widths_take_the_wide_kernels(shape, optimizer):
    assert k1_wrapper._route(*shape, 500, optimizer) == "wide"
    assert k3._route(*shape) == "wide"


@pytest.mark.parametrize("shape", FUSED_WIDTHS)
def test_fused_widths_stay_fused(shape):
    assert k1_wrapper._route(*shape, 500) == "fused"
    assert k3._route(*shape) == "fused"


@pytest.mark.parametrize("shape,optimizer,batch", [
    ((3, 32, 2), "adam", 500),      # fnn_hidden_dim = 32 (train_general)
    ((3, 0, 2), "sgd", 50),         # SEA's lr (F % 4 != 0)
    ((3, 10, 2), "sgd", 500),       # SEA's fnn under SGD
    ((784, 10, 10), "adam", 513),   # more than 16 CTAs of 32 rows
    ((784, 10, 10), "adam", 32),    # one CTA: its moments do not fit
    ((784, 20, 10), "adam", 500)])  # a first layer wider than 16
def test_other_shapes_keep_the_general_kernel(shape, optimizer, batch):
    assert k1_wrapper._route(*shape, batch, optimizer) == "general"


def test_eval_keeps_the_general_kernel_where_the_wide_one_cannot_take():
    assert k3._route(3, 32, 2) == k3._route(3, 0, 2) == "general"
    assert k3._route(786, 10, 10) == "general"      # F % 4 != 0
    assert k3._route(784, 65, 10) == "general"


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("shape", [MNIST_FNN, MNIST_LR])
def test_wide_budget_takes_mnist(shape, optimizer):
    assert k1_wrapper.wide_smem_bytes(*shape, 500, optimizer) \
        <= k1_wrapper.MAX_SMEM
    assert k3.wide_smem_bytes(*shape) <= k3.MAX_SMEM


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_femnist_fnn_takes_the_wide_eval_but_not_the_wide_step(optimizer):
    """784 -> 10 -> 62 fits K1's wide budget, but its 62 classes are more
    than a warp's lanes: K1 keeps the general kernel (which refuses it for
    shared memory), K3 takes its wide one."""
    assert k1_wrapper.wide_smem_bytes(*FEMNIST_FNN, 500, optimizer) \
        <= k1_wrapper.MAX_SMEM
    assert k1_wrapper._route(*FEMNIST_FNN, 500, optimizer) == "general"
    assert k3._route(*FEMNIST_FNN) == "wide"


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("shape", [CIFAR10_FNN, FMOW_FNN])
def test_wide_budget_refuses_cifar10_and_fmow(shape, optimizer):
    assert k1_wrapper.wide_smem_bytes(*shape, 500, optimizer) \
        > k1_wrapper.MAX_SMEM
    assert k1_wrapper._route(*shape, 500, optimizer) == "general"
    assert k3.wide_smem_bytes(*shape) > k3.MAX_SMEM
    assert k3._route(*shape) == "general"


def test_wide_budget_counts_the_layout():
    """MNIST's fnn under AMSGrad: 32 rows of x at stride 788, the params,
    their partials, 500 coordinates of three moments (a sixteenth of 7960,
    in float4s), the mask, h and dh at 16 wide, dz, the labels and the
    warps' losses, after the 16-byte mbarrier; K3: the rows, eight [32, 8]
    tiles, six models' second layers and the warps' totals."""
    P = 784 * 10 + 10 + 100 + 10
    floats = 32 * 788 + 2 * P + 3 * 500 + 784 + 2 * 32 * 16 + 32 * 10 \
        + 32 + 8 + 4
    assert k1_wrapper.wide_smem_bytes(*MNIST_FNN, 500) == 16 + 4 * floats
    assert k3.wide_smem_bytes(*MNIST_FNN) == 16 + 4 * (
        32 * 788 + 8 * 32 * 8 + 6 * (10 + 100 + 10) + 16)
    assert k1_wrapper._wide_stride(784) == 788
    assert k1_wrapper._wide_stride(64) == 68
    assert k1_wrapper._wide_stride(3072) == 3076


def test_forced_wide_route_refuses_what_it_cannot_take():
    x = torch.zeros(1, 2, 8, 3)
    with pytest.raises(ValueError, match="route 'wide'"):
        k1_wrapper._launch(x, torch.zeros(2, 8, dtype=torch.int32),
                           torch.zeros(1, 3 * 10 + 10 + 10 * 2 + 2), {},
                           None, None, torch.zeros(1, 1), hidden=10,
                           batch_size=8, lr=LR, wd=WD, lr_scale=1.0,
                           route="wide", idx=torch.zeros(
                               1, 1, 1, 8, dtype=torch.int32),
                           feat_mask=None)


# --------------------------------------------------------------------------
# On the card: the kernels against their plain versions at MNIST's width

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _mnist_round(model, optimizer, seed, gather=False, masked=False):
    """One MNIST-4 round's inputs on the card: 4 models, 10 clients, 11
    steps of 500 rows, batch 500, 5 steps, pair (1, 3) and model 3
    inactive."""
    rng = np.random.default_rng(seed)
    Mc, Cc, T1, Nn, Bb, Ss = 4, 10, 11, 500, 500, 5
    mod = LogisticRegression((784,), 10) if model == "lr" \
        else FeedForwardNN((784,), 10, 10)
    dev = lambda a: torch.from_numpy(a).cuda()
    x = rng.normal(0.3, 0.5, (Cc, T1, Nn, 784)).astype(np.float32)
    y = rng.integers(0, 10, (Cc, T1, Nn)).astype(np.int32)
    flat = (rng.standard_normal((Mc, mod.num_params)) * 0.05) \
        .astype(np.float32)
    tw = (rng.random((Mc, Cc, T1)) < 0.5).astype(np.float32)
    tw[1, 3] = tw[3] = 0
    kw = dict(hidden=mod.hidden_dim, batch_size=Bb, lr=0.01, wd=0.001,
              optimizer=optimizer)
    t_idx = slot = None
    if gather:
        kw["idx"] = dev(rng.integers(0, T1 * Nn, (Mc, Cc, Ss, Bb))
                        .astype(np.int32))
    else:
        t_idx = dev(rng.integers(0, T1 - 1, (Mc, Cc, Ss)).astype(np.int32))
        slot = dev(np.zeros((Mc, Cc, Ss), np.int32))
    if masked:
        fm = (rng.random((Mc, 784)) < 0.7).astype(np.float32)
        kw["feat_mask"] = dev(fm)
    state = lambda: init_opt_state(Mc, Cc, mod.num_params, "cuda", optimizer)
    return (dev(x), dev(y), dev(flat), t_idx, slot, dev(tw.sum(-1))), kw, \
        state


@pytest.mark.gpu
@pytest.mark.parametrize("model,optimizer,gather,masked", [
    ("fnn", "adam", False, False), ("fnn", "adam", True, True),
    ("lr", "adam", False, False), ("lr", "sgd", False, True),
    ("fnn", "sgd", True, False)])
def test_wide_k1_matches_plain_at_mnist_width(cuda, model, optimizer, gather,
                                              masked):
    """Under SGD params and losses at atol 1e-5; under AMSGrad as far from
    the plain version in float64 as the float32 plain version (twice as
    many coordinates off, plus 1e-4 of them; the losses within twice its
    distance plus 1e-5) and no param further than S steps of lr; n and
    count equal, inactive pairs untouched, two calls bitwise, each one
    launch of the wide kernel."""
    (x, y, flat, t_idx, slot, total_w), kw, state = _mnist_round(
        model, optimizer, 50, gather, masked)
    wide = local_sgd.wide_launches
    got = local_sgd(x, y, flat, state(), t_idx, slot, total_w, **kw)
    again = local_sgd(x, y, flat, state(), t_idx, slot, total_w, **kw)
    torch.cuda.synchronize()
    assert local_sgd.wide_launches == wide + 2
    want = local_sgd_ref(x, y, flat, state(), t_idx, slot, total_w, **kw)
    assert torch.equal(got[0], again[0]) and torch.equal(got[3], again[3])
    assert torch.equal(got[2], want[2])
    over = lambda a, b, atol=0.0, rtol=0.0: int(
        ((a - b).abs() > atol + rtol * b.abs()).sum())
    if optimizer == "sgd":
        assert float((got[0] - want[0]).abs().max()) <= 1e-5
        assert float((got[3] - want[3]).abs().max()) <= 1e-5
    else:
        assert torch.equal(got[1]["count"], want[1]["count"])
        exact = local_sgd_ref(
            x.double(), y, flat.double(),
            {k: v.double() if v.is_floating_point() else v
             for k, v in state().items()}, t_idx, slot, total_w, **kw)
        off = [over(c.double(), exact[0], 1e-5)
               + over(o["mu"].double(), exact[1]["mu"], 1e-5)
               + sum(over(o[k].double(), exact[1][k], rtol=1e-4)
                     for k in ("nu", "nu_max"))
               for c, o in ((got[0], got[1]), (want[0], want[1]))]
        assert off[0] <= 2 * off[1] + 1e-4 * 4 * got[0].numel()
        assert float((got[0] - want[0]).abs().max()) <= 5 * kw["lr"]
        loss_off = [float((l.double() - exact[3]).abs().max())
                    for l in (got[3], want[3])]
        assert loss_off[0] <= 2 * loss_off[1] + 1e-5
    inactive = total_w == 0
    assert torch.equal(got[0][inactive],
                       flat[:, None].expand_as(got[0])[inactive])


@pytest.mark.gpu
@pytest.mark.parametrize("model,window,masked,models,rows", [
    ("fnn", "G2", False, 4, 500), ("fnn", "T1", False, 4, 500),
    ("fnn", "G2", True, 4, 500), ("fnn", "G2", False, 10, 500),
    ("lr", "G2", False, 4, 500), ("lr", "T1", True, 4, 500),
    ("fnn", "G2", False, 4, 40)])
def test_wide_k3_matches_plain_at_mnist_width(cuda, model, window, masked,
                                              models, rows):
    """Counts equal but for rows whose top two plain outputs lie within
    1e-5, NLL to 1e-4 relative, two calls bitwise, one wide launch each;
    M = 10 runs as two groups on the same staged rows; 40 rows a step take
    a cluster of two CTAs, the second with 8 rows."""
    rng = np.random.default_rng(60 + models)
    mod = LogisticRegression((784,), 10) if model == "lr" \
        else FeedForwardNN((784,), 10, 10)
    flat = torch.from_numpy((rng.standard_normal((models, mod.num_params))
                             * 0.05).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.normal(0.3, 0.5, (10, 11, 500, 784))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 10, (10, 11, 500))
                         .astype(np.int32)).cuda()
    xw, yw = (x[:, 4:6], y[:, 4:6]) if window == "G2" else (x, y)
    xw, yw = xw[:, :, :rows], yw[:, :, :rows]
    fm = torch.from_numpy((rng.random((models, 784)) < 0.7)
                          .astype(np.float32)).cuda() if masked else None
    nll_on = window == "G2"
    kw = dict(hidden=mod.hidden_dim, feat_mask=fm, with_nll=nll_on)
    wide = eval_cells.wide_launches
    got = eval_cells(flat, xw, yw, **kw)
    again = eval_cells(flat, xw, yw, **kw)
    torch.cuda.synchronize()
    assert eval_cells.wide_launches == wide + 2
    want = eval_cells_ref(flat, xw, yw, **kw)
    assert torch.equal(got[0], again[0])
    leaves = [v[:, None, None] for v in _unpack(flat, 784, mod.hidden_dim,
                                                10)]
    xin = xw[None] if fm is None else xw[None] * fm[:, None, None, None, :]
    if mod.hidden_dim:
        w0, b0, w1, b1 = leaves
        z = torch.relu(xin @ w0 + b0.unsqueeze(-2)) @ w1 + b1.unsqueeze(-2)
    else:
        w, b = leaves
        z = torch.sigmoid(xin @ w + b.unsqueeze(-2))
    top = z.topk(2, dim=-1).values
    ties = ((top[..., 0] - top[..., 1]) <= 1e-5).sum(-1)
    assert ((got[0] - want[0]).abs() <= ties).all()
    if nll_on:
        assert torch.equal(got[1], again[1])
        assert ((got[1] - want[1]).abs() <= 1e-4 * want[1].abs()).all()


@pytest.mark.gpu
def test_budget_mirrors_equal_the_kernels_own(cuda):
    """``wide_smem_bytes`` in both wrappers counts as the sources do."""
    import ctypes

    from feddrift_torch.kernels.build import library
    fn1 = library("local_sgd").local_sgd_wide_smem
    fn1.restype = ctypes.c_longlong
    fn3 = library("eval_cells").eval_cells_wide_smem
    fn3.restype = ctypes.c_longlong
    for F_, H_, K_ in (MNIST_FNN, MNIST_LR, FEMNIST_FNN, CIFAR10_FNN,
                       (64, 10, 10), (788, 32, 2)):
        for B_ in (40, 500, 512):
            for opt in ("adam", "sgd"):
                assert fn1(F_, H_, K_, B_, int(opt == "sgd")) \
                    == k1_wrapper.wide_smem_bytes(F_, H_, K_, B_, opt)
        assert fn3(F_, H_, K_) == k3.wide_smem_bytes(F_, H_, K_)
