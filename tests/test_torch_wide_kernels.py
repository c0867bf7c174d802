"""K1's wide and split kernels (``csrc/local_sgd.cu::local_sgd_wide_kernel``,
``local_sgd_split_kernel``) and K3's wide route
(``csrc/eval_cells.cu::eval_wide_kernel``, 32-row tiles resident, and
``eval_stream_kernel``, 64-row tiles with F streamed): their routes,
shared-memory budgets and bank layouts on the CPU, and the kernels
themselves against their plain versions on the card (``gpu``), at MNIST-4's
width, at fmow's (F 3072, K 62) and at stackoverflow_lr's (F 1000, K 50,
the split kernel with its last CTA padded past F). The plain versions, ``local_sgd_ref`` and
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
from torch_threads import one_intra_op_thread  # noqa: F401

# the wrapper modules (the package exports their functions under the same
# names)
k1_wrapper = importlib.import_module("feddrift_torch.kernels.local_sgd")
k3 = importlib.import_module("feddrift_torch.kernels.eval_cells")

LR, WD = 0.05, 0.001

# MNIST-4's widths and the unported image datasets' (in, hidden, classes)
MNIST_FNN, MNIST_LR = (784, 10, 10), (784, 0, 10)
FEMNIST_FNN, CIFAR10_FNN, FMOW_FNN = (784, 10, 62), (3072, 10, 10), \
    (3072, 10, 62)
SO_FNN = (1000, 10, 50)       # stackoverflow_lr's fnn at its defaults


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
    """784 -> 10 -> 62 fits K1's wide budget (190,912 bytes under
    AMSGrad), and its 62 classes, more than a warp's lanes, take the row
    phase's two classes a lane: K1 takes the wide kernel now, where it
    kept the general one, and K3 its wide one on 32-row tiles."""
    assert k1_wrapper.wide_smem_bytes(*FEMNIST_FNN, 500, optimizer) \
        <= k1_wrapper.MAX_SMEM
    assert k1_wrapper.wide_smem_bytes(*FEMNIST_FNN, 500) == 190912
    assert k1_wrapper._route(*FEMNIST_FNN, 500, optimizer) == "wide"
    assert k1_wrapper._route(784, 10, 65, 500, optimizer) == "general"
    assert k3._route(*FEMNIST_FNN) == "wide"
    assert k3.wide_rows(*FEMNIST_FNN) == 32


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("shape", [CIFAR10_FNN, FMOW_FNN])
def test_wide_budget_refuses_cifar10_and_fmow(shape, optimizer):
    """32 rows of x at F = 3072 are 394 KB: K1's wide budget and K3's
    resident kernel's refuse cifar10's and fmow's fnn. K1 takes the split
    kernel (a sixteenth of F a CTA, x streamed) within its budget, K3 its
    streamed kernel (64-row tiles, F in chunks), two CTAs an SM."""
    assert k1_wrapper.wide_smem_bytes(*shape, 500, optimizer) \
        > k1_wrapper.MAX_SMEM
    assert k1_wrapper.split_smem_bytes(*shape, 500, optimizer) \
        <= k1_wrapper.MAX_SMEM
    assert k1_wrapper._route(*shape, 500, optimizer) == "split"
    assert k3.wide_smem_bytes(*shape) > k3.MAX_SMEM
    assert 2 * (k3.stream_smem_bytes(*shape[1:]) + 1024) <= 233472
    assert k3.wide_rows(*shape) == k3.STREAM_ROWS == 64
    assert k3._route(*shape) == "wide"


def test_split_budget_counts_the_layout():
    """fmow's fnn under AMSGrad: 4 stages' mbarriers, then 4 tiles of 32
    rows of 192 inputs at stride 196, the forward's eight warps' [32, 10]
    partials of two tiles, W1's slice (1920) and its three moments, the
    mask's slice, dh at stride 12 and Z1's partials of 500 rows, the small
    params (692) and their partials, three moments of the sixteenth of them
    the CTA steps (44), h and dz of 32 rows, the labels, the warps' losses
    and the loss, and two steps' 500 row indices: 215,808 bytes."""
    FQ, W, SP = 192, 1920, 10 + 620 + 62
    floats = 4 * 32 * 196 + 2 * 8 * 32 * 10 + 4 * W + FQ + 500 * 12 \
        + 500 * 10 + 2 * SP + 3 * 44 + 32 * (10 + 62) + 32 + 8 + 4 + 2 * 500
    assert k1_wrapper.split_smem_bytes(*FMOW_FNN, 500) == 32 + 4 * floats \
        == 215808
    assert k1_wrapper._wide_stride(192) == 196


def test_stream_budget_counts_the_layout():
    """K3's streamed kernel at fmow's fnn: a ring of 3 stages, each 64 rows
    of a 32-input chunk at stride 36 and the widest group's (6 models, 60
    columns) W0 rows and mask values of the chunk at stride 72, which also
    holds the four k-steps' [64, 64] partials; six models' second layers
    and the warps' totals: 99,616 bytes whatever F, so two CTAs share an
    SM."""
    stage = 64 * 36 + 2 * 32 * 72
    assert 4 * 64 * 64 <= 3 * stage
    assert k3.stream_smem_bytes(10, 62) == 4 * (
        3 * stage + 6 * (10 + 620 + 62) + 16) == 99616
    assert k3._wide_stride(32) == 36
    # the lr at fmow's width: one model of 62 columns a group
    assert k3.stream_smem_bytes(0, 62) == 4 * (
        3 * (64 * 36 + 2 * 32 * 72) + 62 + 16)


@pytest.mark.parametrize("cols", range(1, 65))
def test_stream_w0_stride_spreads_b_fragments_over_the_banks(cols):
    """A B fragment of the streamed kernel reads W0[k0 + t4][n0 + g8] of a
    chunk at row stride ``_stream_ns(cols)``: the 32 lanes hit 32 banks,
    and the stride holds the group's columns in whole n8 tiles."""
    ns = k3._stream_ns(cols)
    assert ns >= -(-cols // 8) * 8 and ns % 8 == 0
    banks = {(t4 * ns + g8) % 32 for t4 in range(4) for g8 in range(8)}
    assert len(banks) == 32


@pytest.mark.parametrize("shape,batch,optimizer", [
    ((3072, 0, 10), 500, "adam"),   # the lr at fmow's width: not split
    ((3072, 10, 65), 500, "adam"),  # more than 64 classes
    ((3072, 17, 62), 500, "sgd"),   # more than 16 hidden units
    ((3074, 10, 62), 500, "adam"),  # F % 4 != 0
    ((3072, 10, 62), 513, "adam"),  # more than 16 x 32 rows
    ((16384, 10, 62), 500, "adam")])  # 1024 inputs a CTA: over budget
def test_split_refuses_what_it_cannot_take(shape, batch, optimizer):
    assert k1_wrapper._route(*shape, batch, optimizer) == "general"


def test_stackoverflow_lr_fnn_takes_the_split_kernel_under_amsgrad():
    """1000 -> 10 -> 50 at B 500: AMSGrad misses the wide kernel's budget
    by 3,152 bytes and takes the split kernel, each CTA 64 inputs (a
    sixteenth of 1000 rounded up to float4s), the last 40 and 24 slots of
    padding; SGD keeps the wide kernel; K3 takes its resident 32-row
    tiles."""
    assert k1_wrapper.wide_smem_bytes(*SO_FNN, 500) \
        == k1_wrapper.MAX_SMEM + 3152
    assert k1_wrapper._route(*SO_FNN, 500, "adam") == "split"
    assert k1_wrapper._route(*SO_FNN, 500, "sgd") == "wide"
    assert k1_wrapper.split_fq(1000) == 64
    assert 15 * 64 + 40 == 1000
    assert k3._route(*SO_FNN) == "wide" and k3.wide_rows(*SO_FNN) == 32


@pytest.mark.parametrize("F", [3072, 192, 1024, 64])
def test_split_inputs_a_cta_are_a_sixteenth_where_f_divides(F):
    """Where F % 64 == 0 a CTA's inputs are F / 16, as they were before the
    padding existed: the split kernel's existing shapes keep their
    layout."""
    assert k1_wrapper.split_fq(F) == F // 16


def test_split_budget_counts_the_padded_layout():
    """stackoverflow_lr's fnn under AMSGrad: tiles of 32 rows of 64 inputs
    at stride 68, the forward's partials of two tiles (5,120 floats, more
    than W1's slice of 640), W1's slice and its three moments, the mask's
    slice, dh at stride 12 and Z1's partials of 500 rows, the small params
    (560) and their partials, three moments of 35, h and dz of 32 rows,
    the labels, the losses and two steps' rows: 126,580 bytes."""
    FQ, W, SP = 64, 640, 10 + 500 + 50
    floats = 4 * 32 * 68 + 2 * 8 * 32 * 10 + 4 * W + FQ + 500 * 12 \
        + 500 * 10 + 2 * SP + 3 * 35 + 32 * (10 + 50) + 32 + 8 + 4 + 2 * 500
    assert k1_wrapper.split_smem_bytes(*SO_FNN, 500) == 32 + 4 * floats \
        == 126580


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


def _mnist_round(model, optimizer, seed, gather=False, masked=False,
                 F=784, K=10, Bb=500, Mc=4):
    """One MNIST-4 round's inputs on the card (or, with ``F`` and ``K``,
    another width's): ``Mc`` models (4), 10 clients, 11 steps of 500 rows,
    batch ``Bb`` (500; a smaller one draws its slot in each step), 5
    steps, pair (1, 3) and model 3 inactive (one model: pair (0, 3))."""
    rng = np.random.default_rng(seed)
    Cc, T1, Nn, Ss = 10, 11, 500, 5
    mod = LogisticRegression((F,), K) if model == "lr" \
        else FeedForwardNN((F,), K, 10)
    dev = lambda a: torch.from_numpy(a).cuda()
    x = rng.normal(0.3, 0.5, (Cc, T1, Nn, F)).astype(np.float32)
    y = rng.integers(0, K, (Cc, T1, Nn)).astype(np.int32)
    flat = (rng.standard_normal((Mc, mod.num_params)) * 0.05) \
        .astype(np.float32)
    tw = (rng.random((Mc, Cc, T1)) < 0.5).astype(np.float32)
    tw[min(1, Mc - 1), 3] = 0
    tw[3:] = 0
    kw = dict(hidden=mod.hidden_dim, batch_size=Bb, lr=0.01, wd=0.001,
              optimizer=optimizer)
    t_idx = slot = None
    if gather:
        kw["idx"] = dev(rng.integers(0, T1 * Nn, (Mc, Cc, Ss, Bb))
                        .astype(np.int32))
    else:
        t_idx = dev(rng.integers(0, T1 - 1, (Mc, Cc, Ss)).astype(np.int32))
        slot = dev(np.zeros((Mc, Cc, Ss), np.int32) if Bb == Nn
                   else rng.integers(0, Nn // Bb, (Mc, Cc, Ss))
                   .astype(np.int32))
    if masked:
        fm = (rng.random((Mc, F)) < 0.7).astype(np.float32)
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
    _hold_k1(_mnist_round(model, optimizer, 50, gather, masked), optimizer,
             "wide_launches")


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer,gather,masked,K_,counter", [
    ("adam", False, False, 62, "split_launches"),
    ("adam", True, True, 62, "split_launches"),
    ("sgd", False, True, 62, "split_launches"),
    ("adam", False, False, 10, "split_launches")])
def test_split_k1_matches_plain_at_fmow_width(cuda, optimizer, gather, masked,
                                              K_, counter):
    """K1's split kernel at fmow's width (F 3072, H 10, K 62; and
    cifar10's K 10), held as the wide kernel is at MNIST's."""
    _hold_k1(_mnist_round("fnn", optimizer, 51, gather, masked, F=3072,
                          K=K_), optimizer, counter)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer,gather,masked,batch", [
    ("adam", False, False, 32), ("adam", True, True, 32),
    ("sgd", False, False, 20), ("adam", False, True, 64)])
def test_split_k1_small_batches_match_plain(cuda, optimizer, gather, masked,
                                            batch):
    """The split kernel where a step has as few x tiles as its ring has
    stages or fewer (B <= 64: 2 or 4 tiles a step), so the ring would run
    past the steps whose rows are staged: held as at B = 500."""
    assert k1_wrapper._route(3072, 10, 62, batch, optimizer) == "split"
    _hold_k1(_mnist_round("fnn", optimizer, 53, gather, masked, F=3072,
                          K=62, Bb=batch), optimizer, "split_launches")


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer,gather,masked,batch", [
    ("adam", False, False, 500), ("adam", True, True, 500),
    ("sgd", True, True, 500), ("adam", False, False, 64),
    ("sgd", False, False, 32), ("adam", True, True, 20)])
def test_split_k1_matches_plain_with_one_model(cuda, optimizer, gather,
                                               masked, batch):
    """The split kernel at fmow's width with one model (win-1's and
    oblivious's pool: 10 clusters, a wave of two), held as with four."""
    _hold_k1(_mnist_round("fnn", optimizer, 54, gather, masked, F=3072,
                          K=62, Bb=batch, Mc=1), optimizer, "split_launches")


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer,gather,masked,batch,models", [
    ("adam", False, False, 500, 4), ("adam", True, True, 500, 4),
    ("sgd", False, True, 500, 4), ("adam", False, False, 32, 4),
    ("adam", True, True, 500, 1)])
def test_split_k1_matches_plain_at_stackoverflow_lr_width(
        cuda, optimizer, gather, masked, batch, models):
    """The split kernel at stackoverflow_lr's fnn (1000 -> 10 -> 50), its
    last CTA padded past F (forced: SGD's route is the wide kernel, B
    32's the general one), on the dataset's own bag-of-words rows
    (``_so_round``), held as at fmow's width."""
    _hold_k1(_so_round(optimizer, 55, gather, masked, batch, models),
             optimizer, "split_launches")


def _so_round(optimizer, seed, gather, masked, batch, models):
    """One round of stackoverflow_lr's fnn on the card on the dataset's own
    rows at its defaults, as ``chip_smoke.py``'s K1 cases draw them (its
    ``_train_case``; gathered rows and 0/1 feature masks from its
    ``_gathered``, or masks alone), the split route forced. The
    dense N(0.3, 0.5) rows of ``_mnist_round`` at 1000 inputs and 50
    random labels make a pair's five AMSGrad steps rounding-chaotic: on
    them the kernel and the plain version each left float64 on one whole
    pair (the kernel on model 2, the plain version on model 1)."""
    import chip_smoke
    args, kw, dims, tw = chip_smoke._train_case(
        "stackoverflow_lr", seed, optimizer=optimizer, models=models,
        batch=batch)
    x, y, flat, opt, t_idx, slot, total_w = args
    kw = dict(kw, optimizer=optimizer, route="split")
    if gather:
        idx, fm = chip_smoke._gathered(x, tw, dims["S"], dims["B"], seed)
        t_idx = slot = None
        kw.update(idx=idx, feat_mask=fm if masked else None)
    elif masked:
        rng = np.random.default_rng(seed)
        kw["feat_mask"] = torch.from_numpy(
            (rng.random((models, dims["F"])) < 0.7).astype(np.float32)).cuda()
    state = lambda: {k: v.clone() for k, v in opt.items()}
    return (x, y, flat, t_idx, slot, total_w), kw, state


def _pad_inputs(case, F, FP, H):
    """The same round at FP > F inputs: x, W1's rows and the masks padded
    with zeros, the optimizer state at the padded P."""
    (x, y, flat, t_idx, slot, total_w), kw, _ = case
    pad = torch.zeros(flat.shape[0], (FP - F) * H, device=flat.device)
    flatp = torch.cat([flat[:, :F * H], pad, flat[:, F * H:]], 1)
    kw = dict(kw)
    if kw.get("feat_mask") is not None:
        kw["feat_mask"] = torch.nn.functional.pad(kw["feat_mask"],
                                                  (0, FP - F))
    xp = torch.nn.functional.pad(x, (0, FP - F)).contiguous()
    return (xp, y, flatp, t_idx, slot, total_w), kw


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer,gather,masked", [
    ("adam", False, False), ("adam", True, True), ("sgd", True, True)])
def test_split_k1_padding_is_the_unpadded_kernel(cuda, optimizer, gather,
                                                 masked):
    """At F = 1000 (64 inputs a CTA, the last CTA 40 real and 24 padded)
    the split kernel is bitwise the same kernel at F = 1024 (F % 64 == 0:
    no padding) on the inputs zero-padded to 1024 (x, W1's rows, the
    masks), whose rows past 1000 stay zero: the padding adds no term to
    any sum and moves no parameter."""
    F, FP, H = 1000, 1024, 10
    case = _mnist_round("fnn", optimizer, 56, gather, masked, F=F, K=50)
    (x, y, flat, t_idx, slot, total_w), kw, state = case
    kw = dict(kw, route="split")
    got = local_sgd(x, y, flat, state(), t_idx, slot, total_w, **kw)
    args, kwp = _pad_inputs(case, F, FP, H)
    kwp["route"] = "split"
    P = flat.shape[1] + (FP - F) * H
    statep = init_opt_state(flat.shape[0], x.shape[0], P, "cuda", optimizer)
    xp, _, flatp, *draws = args
    padded = local_sgd(xp, y, flatp, statep, *draws, **kwp)
    torch.cuda.synchronize()
    cut = lambda t: torch.cat([t[..., :F * H], t[..., FP * H:]], -1)
    tail = lambda t: t[..., F * H:FP * H]
    assert torch.equal(got[0], cut(padded[0]))
    assert not tail(padded[0]).any()
    assert torch.equal(got[2], padded[2]) and torch.equal(got[3], padded[3])
    for k in got[1]:
        if k == "count":
            assert torch.equal(got[1][k], padded[1][k])
        else:
            assert torch.equal(got[1][k], cut(padded[1][k]))
            assert not tail(padded[1][k]).any()


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_wide_k1_takes_femnist_fnn(cuda, optimizer):
    """The wide kernel's row phase at two classes a lane: femnist-fnn's
    784 -> 10 -> 62."""
    _hold_k1(_mnist_round("fnn", optimizer, 52, K=62), optimizer,
             "wide_launches")


def _hold_k1(case, optimizer, counter):
    (x, y, flat, t_idx, slot, total_w), kw, state = case
    launched = getattr(local_sgd, counter)
    got = local_sgd(x, y, flat, state(), t_idx, slot, total_w, **kw)
    again = local_sgd(x, y, flat, state(), t_idx, slot, total_w, **kw)
    torch.cuda.synchronize()
    assert getattr(local_sgd, counter) == launched + 2
    plain = {k: v for k, v in kw.items() if k != "route"}
    want = local_sgd_ref(x, y, flat, state(), t_idx, slot, total_w, **plain)
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
             for k, v in state().items()}, t_idx, slot, total_w, **plain)
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
    _hold_k3(model, window, masked, models, rows, 784, 10, "wide_launches")


@pytest.mark.gpu
@pytest.mark.parametrize("window,masked,models,rows", [
    ("G2", False, 4, 500), ("T1", False, 4, 500), ("G2", True, 4, 500),
    ("G2", False, 10, 500), ("G2", False, 4, 40), ("G2", False, 1, 500),
    ("T1", True, 1, 500), ("G2", True, 4, 20), ("T1", False, 4, 20)])
def test_stream_k3_matches_plain_at_fmow_width(cuda, window, masked, models,
                                               rows):
    """K3's streamed kernel at fmow's width (F 3072, H 10, K 62), held as
    the resident one is at MNIST's: 500 rows a step are 8 tiles of 64, the
    last with 52; M = 10 in two groups, M = 1 in one of 10 columns; 40 or
    20 rows a step one CTA with a partly full tile."""
    _hold_k3("fnn", window, masked, models, rows, 3072, 62,
             "stream_launches")


def _hold_k3(model, window, masked, models, rows, F, K, counter):
    rng = np.random.default_rng(60 + models)
    mod = LogisticRegression((F,), K) if model == "lr" \
        else FeedForwardNN((F,), K, 10)
    flat = torch.from_numpy((rng.standard_normal((models, mod.num_params))
                             * 0.05).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.normal(0.3, 0.5, (10, 11, 500, F))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, K, (10, 11, 500))
                         .astype(np.int32)).cuda()
    xw, yw = (x[:, 4:6], y[:, 4:6]) if window == "G2" else (x, y)
    xw, yw = xw[:, :, :rows], yw[:, :, :rows]
    fm = torch.from_numpy((rng.random((models, F)) < 0.7)
                          .astype(np.float32)).cuda() if masked else None
    nll_on = window == "G2"
    kw = dict(hidden=mod.hidden_dim, feat_mask=fm, with_nll=nll_on)
    launched = getattr(eval_cells, counter)
    got = eval_cells(flat, xw, yw, **kw)
    again = eval_cells(flat, xw, yw, **kw)
    torch.cuda.synchronize()
    assert getattr(eval_cells, counter) == launched + 2
    want = eval_cells_ref(flat, xw, yw, **kw)
    assert torch.equal(got[0], again[0])
    leaves = [v[:, None, None] for v in _unpack(flat, F, mod.hidden_dim,
                                                K)]
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
    """``wide_smem_bytes``, ``split_smem_bytes``, ``stream_smem_bytes`` and
    ``wide_rows`` in the wrappers count as the sources do."""
    import ctypes

    from feddrift_torch.kernels.build import library
    fn1 = library("local_sgd").local_sgd_wide_smem
    fn1.restype = ctypes.c_longlong
    fn2 = library("local_sgd").local_sgd_split_smem
    fn2.restype = ctypes.c_longlong
    fn3 = library("eval_cells").eval_cells_wide_smem
    fn3.restype = ctypes.c_longlong
    fn4 = library("eval_cells").eval_cells_stream_smem
    fn4.restype = ctypes.c_longlong
    rows = library("eval_cells").eval_cells_wide_rows
    rows.restype = ctypes.c_int
    for F_, H_, K_ in (MNIST_FNN, MNIST_LR, FEMNIST_FNN, CIFAR10_FNN,
                       FMOW_FNN, SO_FNN, (64, 10, 10), (788, 32, 2)):
        for B_ in (40, 500, 512):
            for opt in ("adam", "sgd"):
                assert fn1(F_, H_, K_, B_, int(opt == "sgd")) \
                    == k1_wrapper.wide_smem_bytes(F_, H_, K_, B_, opt)
                if H_ and F_ % 4 == 0:
                    assert fn2(F_, H_, K_, B_, int(opt == "sgd")) \
                        == k1_wrapper.split_smem_bytes(F_, H_, K_, B_, opt)
        assert fn3(F_, H_, K_) == k3.wide_smem_bytes(F_, H_, K_)
        assert fn4(H_, K_) == k3.stream_smem_bytes(H_, K_)
        assert rows(F_, H_, K_) == k3.wide_rows(F_, H_, K_)


@pytest.mark.gpu
def test_fused_budget_mirror_equals_the_kernels_own(cuda):
    """``fused_smem_bytes`` sets the bytes, the ring's stages and the eval
    mode as ``csrc/local_sgd.cu::fused_layout`` does, at every fused width,
    with and without an eval, where the window is staged and where it is
    read where it lies."""
    import ctypes

    from feddrift_torch.kernels.build import library
    fn = library("local_sgd").local_sgd_fused_smem
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)] * 2
    modes = {0: "none", 1: "staged", 2: "staged", 3: "global"}
    for F_, H_, K_ in k1_wrapper.FUSED_WIDTHS:
        for B_, S_, N_ in ((500, 5, 500), (512, 12, 6000), (256, 1, 256),
                           (200, 8, 3000)):
            for ev in (False, True):
                st, em = ctypes.c_int(), ctypes.c_int()
                got = fn(F_, H_, K_, B_, S_, N_, int(ev), 1,
                         ctypes.byref(st), ctypes.byref(em))
                assert (got, st.value, modes[em.value]) \
                    == k1_wrapper.fused_smem_bytes(F_, H_, K_, B_, S_, N_, ev)


@pytest.mark.gpu
def test_general_budget_mirror_and_early_refusal(cuda):
    """``general_smem_bytes`` counts as the source does, and on the card
    ``TrainStep.create`` refuses a shape no K1 layout takes (fmow's lr)
    before any launch."""
    import ctypes

    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.kernels.build import library
    fn = library("local_sgd").local_sgd_general_smem
    fn.restype = ctypes.c_longlong
    for F_, H_, K_ in (MNIST_FNN, MNIST_LR, FMOW_FNN, (3, 10, 2), (3, 0, 2),
                       (1000, 10, 50), (3072, 0, 62)):
        for B_ in (40, 500):
            for opt in ("adam", "sgd"):
                assert fn(F_, H_, K_, B_, int(opt == "sgd")) \
                    == k1_wrapper.general_smem_bytes(F_, H_, K_, B_, opt)
    with pytest.raises(ValueError, match="no K1 layout takes it"):
        TrainStep.create(ExperimentConfig(), LogisticRegression((3072,), 62),
                         62, device=cuda)
