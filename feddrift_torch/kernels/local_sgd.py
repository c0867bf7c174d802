"""Fused local SGD of one round (K1): the CUDA kernel's wrapper and its
plain version.

Counterpart of ``feddrift_tpu/core/step.py::TrainStep._local_sgd`` under
``_round_body``'s double vmap, with ``make_optimizer``'s update:
``"adam"``, ``add_decayed_weights`` + optax AMSGrad, or ``"sgd"``, plain
``optax.sgd(lr)``. The kernel is ``csrc/local_sgd.cu``; its source notes
what bounds it and its design. It trains the model of every (model,
client) pair for S local steps in one launch: the fnn (dense -> relu ->
dense), or with ``hidden = 0`` the lr (``LogisticRegression``: sigmoid
over one dense, whose outputs the loss takes as logits, as the
reference's does).

Shapes (float32 unless noted): ``x [C, T1, N, F]``, ``y [C, T1, N]`` int32,
``params [M, P]`` (the model's leaves packed in ``param_specs`` order: the
fnn's, P = F·H + H + H·K + K, or the lr's, P = F·K + K), the optimizer
state (AMSGrad: ``{"mu", "nu", "nu_max": [M, C, P], "count": [M, C]
int32}``; SGD: ``{}``, optax.sgd keeps none), the batch draws and
``total_w [M, C]``. A batch is either contiguous, ``t_idx, slot [M, C,
S]`` int32 (rows ``t_idx·N + slot·B + [0, B)``), or gathered, ``idx [M,
C, S, B]`` int32 (rows of the pair's client, from the weighted draw K4,
which keeps them in ``[0, T1·N)``). ``feat_mask [M, F]`` multiplies each
model's x (KUE; None: ones). Returns the client params ``[M, C, P]``
(a new buffer), the optimizer state, ``n [M, C]`` (``total_w·N``, 0 for an
inactive pair) and the mean loss over the S steps ``[M, C]``.

``local_sgd`` launches a kernel for CUDA tensors and updates the optimizer
state IN PLACE (the dict it returns is the one it was given); for CPU
tensors it runs ``local_sgd_ref``, which returns a new state. There is no
fallback for a CUDA tensor: the kernel launches or the call raises. The
source holds four kernels of the one function, and ``_route`` picks one
by shape, model and update alone before the launch: the fused kernel (one
batch row a thread, two barriers a step; at susy's and ro's widths the
row's P + 1 values folded 32 at a time) for the fnn widths it is built
for under AMSGrad, where its block has a thread for each parameter and the
loss; the wide kernel (a cluster of CTAs a pair, 32 batch rows
each staged by TMA, both products in float32 FMAs) for rows of a multiple
of 4 floats, such as MNIST-4's F = 784 (and femnist's fnn, 62 classes, two
a lane), the fnn or the lr, AMSGrad or SGD, where ``wide_smem_bytes``
fits; the split kernel (a cluster of 16 CTAs a pair, each a sixteenth of
the inputs, x streamed through shared memory twice a step) for the fnn at
inputs the wide kernel's budget refuses, such as fmow's F = 3072 or
stackoverflow_lr's F = 1000 under AMSGrad (a sixteenth rounded up to
float4s, ``split_fq``, the last CTA padded past F), where
``split_smem_bytes`` fits; the general kernel for the rest (e.g.
``fnn_hidden_dim = 32``, the lr at SEA's F = 3, SGD at susy's width).
``local_sgd.launches`` counts every launch, ``local_sgd.fused_launches``
the fused kernel's, ``local_sgd.wide_launches`` the wide kernel's and
``local_sgd.split_launches`` the split kernel's.

``local_sgd_fedavg`` is a round's K1 and K2 in one launch: the fused
kernel with the masked FedAvg (``kernels/fedavg.py``'s function, bitwise)
as its epilogue, so the round path makes one launch where it made two. The
general kernel has no epilogue; on its route the caller launches K2.
``local_sgd_fedavg_ref`` (``local_sgd_ref``, then ``fedavg_ref``) is its
plain version.

``local_sgd_fedavg`` also takes an eval (K3) of its INPUT params: given a
two-step window ``eval_window = (x[:, t:t + 2], y[:, t:t + 2])`` and
``eval_out = (correct, nll)`` (``[M, C, 2]``, e.g. slot e of the fused
loop's buffers), block (m, c) of the same launch writes the cells that
``kernels/eval_cells.py``'s blocks (m, c, 0) and (m, c, 1) would write,
bitwise, through the cell code both kernels share
(``csrc/fnn_eval.cuh``). ``_folds_eval`` says by shape which rounds can
take it: where it is False the caller launches ``eval_cells`` instead, and
a request the fold cannot take raises. ``local_sgd_fedavg.evals`` counts
the evals folded into a launch.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from feddrift_torch.kernels.build import library
from feddrift_torch.kernels.eval_cells import _route as _eval_route
from feddrift_torch.kernels.eval_cells import _threads as _eval_threads
from feddrift_torch.kernels.eval_cells import (FUSED_WIDTHS, MAX_SMEM,
                                               WIDE_MAX_CLUSTER, WIDE_ROWS,
                                               _apply, _classes, _unpack,
                                               _wide_stride, eval_cells_ref)
from feddrift_torch.kernels.fedavg import fedavg_ref

B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.amsgrad defaults
MAX_BLOCKS = 2 ** 31 - 1
# csrc/local_sgd.cu's kErrSmem: the shape needs more shared memory per block
# than the kernel may take (the size and the limit live in that file only)
_ERR_SMEM = -1
# The fused kernel's widths are K3's FUSED_WIDTHS (imported above: one list,
# which both entry points' dispatch lines must match, local_sgd_f32's in
# csrc/local_sgd.cu and eval_cells_f32's in csrc/eval_cells.cu), and its
# most rows (a block)
FUSED_MAX_BATCH = 512
# csrc/local_sgd.cu's fused kernel: batch stages of its ring at most, and at
# least where an eval window wants the room; a row's values folded at once
# up to FOLD_ONE, else FOLD_CHUNK at a time; its mbarriers' bytes; the
# eval's warps at most
FUSED_STAGES, FUSED_MIN_STAGES = 8, 2
FOLD_ONE, FOLD_CHUNK = 64, 32
_BAR_BYTES = 8 * (FUSED_STAGES + 2)
_EVAL_WARPS = 16
# local_sgd_f32's route
_ROUTES = {"general": 0, "fused": 1, "wide": 2, "split": 3}
OPTIMIZERS = ("adam", "sgd")              # the reference's make_optimizer
# csrc/local_sgd.cu's wide kernel: the units of its first layer and the
# fnn's classes (two a lane) at most (its other sizes are K3's:
# eval_cells.WIDE_ROWS, ...)
WIDE_MAX_WIDTH, WIDE_MAX_CLASSES = 16, 64
# csrc/local_sgd.cu's split kernel: CTAs a pair, rows a tile (and a CTA's
# rows in the row phase), tiles in flight, hidden units and classes at
# most, inputs a CTA at most
SPLIT_CLUSTER, SPLIT_ROWS, SPLIT_STAGES = 16, 32, 4
SPLIT_MAX_H, SPLIT_MAX_K, SPLIT_MAX_FQ = 16, 64, 1024
# csrc/local_sgd.cu's general kernel: warps a block
GENERAL_WARPS = 8
# the ROADMAP item that queues the shapes no K1 layout takes yet
LAYOUT_ITEM = ("ROADMAP §2 'K1 and K3 at wide inputs: what PRs 12, 14 and "
               "15 left' (shapes no layout takes yet)")


def wide_smem_bytes(F: int, H: int, K: int, B: int,
                    optimizer: str = "adam") -> int:
    """Shared memory of one CTA of the wide kernel (``H = 0``: the lr), as
    ``csrc/local_sgd.cu::wide_smem_bytes`` counts it: the mbarrier, 32 rows
    of x at the padded stride, the params and the gradient partials (each
    padded to float4s), the CTA's slice of the AMSGrad moments (a Q-th of
    P in float4s), the mask, h and dh (16 wide), the fnn's dz, the labels
    and the warps' losses."""
    P = F * H + H + H * K + K if H else F * K + K
    PP = -(-P // 4) * 4
    Q = -(-B // WIDE_ROWS)
    chunk = -(-P // Q)                 # the owned slice, in float4s
    chunk = -(-chunk // 4) * 4
    parts = 2 * WIDE_ROWS * WIDE_MAX_WIDTH
    floats = (WIDE_ROWS * _wide_stride(F) + PP + max(PP, parts)
              + (0 if optimizer == "sgd" else 3 * chunk) + F
              + 2 * WIDE_ROWS * WIDE_MAX_WIDTH + (WIDE_ROWS * K if H else 0)
              + WIDE_ROWS + 8 + 4)
    return 16 + 4 * floats


def _wide_fits(F: int, H: int, K: int, B: int, optimizer: str) -> bool:
    """Whether the wide kernel takes the shape: 16-byte rows (F % 4 ==
    0), a first layer of at most 16 units and at most 64 classes (one or
    two a lane), at most 16 CTAs of 32 rows, and its shared memory within
    a block's."""
    return F % 4 == 0 and 1 <= (H or K) <= WIDE_MAX_WIDTH \
        and K <= WIDE_MAX_CLASSES \
        and 1 <= B <= WIDE_ROWS * WIDE_MAX_CLUSTER \
        and wide_smem_bytes(F, H, K, B, optimizer) <= MAX_SMEM


def general_smem_bytes(F: int, H: int, K: int, B: int,
                       optimizer: str = "adam") -> int:
    """Shared memory of one block of the general kernel (``H = 0``: the
    lr), as ``csrc/local_sgd.cu::general_smem_bytes`` counts it: the
    params and their optimizer state (5 arrays of P under AMSGrad, 2 under
    SGD), the batch's activations, the warps' losses and the mask."""
    P = F * H + H + H * K + K if H else F * K + K
    arrays = 2 if optimizer == "sgd" else 5
    return 4 * (arrays * P + B * (H + K) + GENERAL_WARPS + F)


def split_fq(F: int) -> int:
    """Inputs a CTA of the split kernel takes (``csrc/local_sgd.cu::
    split_fq``): a sixteenth of F rounded up to whole float4s, F / 16 where
    F % 64 == 0; the last CTAs' slots past F are padding."""
    return -(-F // (4 * SPLIT_CLUSTER)) * 4


def split_smem_bytes(F: int, H: int, K: int, B: int,
                     optimizer: str = "adam") -> int:
    """Shared memory of one CTA of the split kernel, as
    ``csrc/local_sgd.cu::split_smem_bytes`` counts it: the stages'
    mbarriers, then the x ring (4 tiles of 32 rows of ``split_fq(F)``
    inputs at the padded stride), the forward's warp partials of two tiles or dW1's
    slice, W1's slice and (AMSGrad) its three moments, the mask's slice, dh
    (rows padded to float4s) and Z1's partials of every batch row, the
    small params (b1, W2, b2) and their partials, (AMSGrad) the moments of
    the sixteenth of them the CTA steps, h and dz of the CTA's 32 rows,
    their labels, the warps' losses and the loss, and the batch's row
    indices of two steps."""
    FQ = split_fq(F)
    W, SP = H * FQ, H + H * K + K
    red = 2 * 8 * SPLIT_ROWS * H
    sgd = optimizer == "sgd"
    floats = (SPLIT_STAGES * SPLIT_ROWS * _wide_stride(FQ) + max(red, W)
              + (1 if sgd else 4) * W + FQ + B * (-(-H // 4) * 4) + B * H
              + 2 * SP + (0 if sgd else 3 * -(-SP // SPLIT_CLUSTER))
              + SPLIT_ROWS * (H + K) + SPLIT_ROWS
              + 8 + 4 + 2 * B)
    return 8 * SPLIT_STAGES + 4 * floats


def _split_fits(F: int, H: int, K: int, B: int, optimizer: str) -> bool:
    """Whether the split kernel takes the shape: the fnn, 16-byte rows (F
    % 4 == 0: whole float4s of every row in each of its 16 CTAs, the last
    ones padded past F where F % 64 != 0) and at most 1024 inputs a CTA,
    at most 16 hidden units and 64 classes, B <= 512, and its shared
    memory within a block's."""
    return H >= 1 and F % 4 == 0 \
        and split_fq(F) <= SPLIT_MAX_FQ and H <= SPLIT_MAX_H \
        and 1 <= K <= SPLIT_MAX_K and 1 <= B <= SPLIT_ROWS * SPLIT_CLUSTER \
        and split_smem_bytes(F, H, K, B, optimizer) <= MAX_SMEM


def fused_threads(B: int) -> int:
    """The fused kernel's block at batch ``B``: one row a thread,
    round_up(B, 32) and at least 64 threads (``csrc/local_sgd.cu::
    fused_threads``)."""
    return max(64, -(-B // 32) * 32)


def fused_smem_bytes(F: int, H: int, K: int, B: int, S: int, N: int = 0,
                     eval_window: bool = False) -> tuple[int, int, str]:
    """``(bytes, stages, eval mode)`` of one block of the fused kernel, as
    ``csrc/local_sgd.cu::fused_layout`` sets them: a batch ring of min(S,
    8) stages, fewer where they would not fit a block; with an eval on
    ``N``-row steps the ring gives up stages, down to 2, until the window
    fits beside it (``"staged"``), else the window is read where it lies
    (``"global"``); ``"none"`` without an eval. Bytes: the mbarriers, the
    stages' rows and labels, the warps' partials of the P + 1 values (padded
    to whole folds), the params and, folding in chunks, the mask; with an
    eval the input params, the mask and the warp totals, then the window's
    rows and labels, each 16-byte aligned."""
    P = F * H + H + H * K + K
    V = -(-(P + 1) // 32) * 32 if P + 1 <= FOLD_ONE \
        else -(-(P + 1) // FOLD_CHUNK) * FOLD_CHUNK
    fm = F if P + 1 > FOLD_ONE else 0
    fixed = _BAR_BYTES + 4 * (fused_threads(B) // 32) * V + 4 * (P + fm)
    ring = lambda st: fixed + 4 * st * B * (F + 1)
    head = lambda st: -(-(ring(st) + 4 * (P + F + 4 * _EVAL_WARPS)) // 16) \
        * 16
    stages = min(S, FUSED_STAGES)
    while stages > 1 and ring(stages) > MAX_SMEM:
        stages -= 1
    if not eval_window:
        return ring(stages), stages, "none"
    window = -(-8 * N * F // 16) * 16 + -(-8 * N // 16) * 16
    for st in range(stages, min(stages, FUSED_MIN_STAGES) - 1, -1):
        if head(st) + window <= MAX_SMEM:
            return head(st) + window, st, "staged"
    return head(stages), stages, "global"


def _route(F: int, H: int, K: int, B: int, optimizer: str = "adam") -> str:
    """Which kernel takes a ``F -> H -> K`` fnn (``H = 0``: the lr) at
    batch ``B`` under ``optimizer``: by shape, model and update alone,
    decided before the launch. The fused kernel takes its widths under
    AMSGrad where its block has a thread for each parameter and the loss
    (susy's P 212 from B = 193 on, ro's P 82 from B = 65); below that the
    general kernel does."""
    if (F, H, K) in FUSED_WIDTHS and B <= FUSED_MAX_BATCH \
            and optimizer == "adam" \
            and fused_threads(B) >= F * H + H + H * K + K + 1:
        return "fused"
    if _wide_fits(F, H, K, B, optimizer):
        return "wide"
    # the split kernel pads its last CTAs where F % 64 != 0; there it takes
    # only what the general kernel's shared memory refuses, so every shape
    # the general kernel took before the padding existed keeps it
    if _split_fits(F, H, K, B, optimizer) and (
            F % (4 * SPLIT_CLUSTER) == 0
            or general_smem_bytes(F, H, K, B, optimizer) > MAX_SMEM):
        return "split"
    return "general"


def layout_refusal(F: int, H: int, K: int, B: int,
                   optimizer: str = "adam") -> "str | None":
    """Why the card cannot train a ``F -> H -> K`` fnn (``H = 0``: the lr)
    at batch ``B`` under ``optimizer``, or None where a K1 layout takes
    it: every other route refuses the shape and the general kernel's
    shared memory (``general_smem_bytes``) exceeds a block's. The CPU's
    plain version takes every shape. It concerns the fnn and the lr only:
    the conv models take no K1 layout."""
    if _route(F, H, K, B, optimizer) != "general" \
            or general_smem_bytes(F, H, K, B, optimizer) <= MAX_SMEM:
        return None
    model = f"the fnn {F} -> {H} -> {K}" if H else f"the lr {F} -> {K}"
    return (f"{model} at batch {B} under {optimizer!r}: no K1 layout takes "
            f"it on the card (the fused, wide and split kernels refuse the "
            f"shape, and the general kernel needs "
            f"{general_smem_bytes(F, H, K, B, optimizer)} bytes of shared "
            f"memory a block, above {MAX_SMEM}); {LAYOUT_ITEM}")


def _folds_eval(F: int, H: int, K: int, B: int, N: int,
                optimizer: str = "adam") -> bool:
    """Whether a round at batch ``B`` can evaluate its input params on
    ``N``-row steps in its own launch: K1 and K3 both take their fused
    kernels, and K1's block (one batch row a thread, round_up(B, 32) and at
    least 64 threads) is K3's (``eval_cells._threads(N)``), so the cells'
    sums run over the same tree and are bitwise K3's."""
    return _route(F, H, K, B, optimizer) == "fused" \
        and _eval_route(F, H, K) == "fused" \
        and max(64, -(-B // 32) * 32) == _eval_threads(N)


def init_opt_state(M: int, C: int, P: int, device: str | torch.device,
                   optimizer: str = "adam") -> dict[str, torch.Tensor]:
    """Fresh optimizer state of every pair: AMSGrad's (optax's init:
    zeros, count 0), or SGD's, which is empty."""
    if optimizer == "sgd":
        return {}
    return {"mu": torch.zeros(M, C, P, device=device),
            "nu": torch.zeros(M, C, P, device=device),
            "nu_max": torch.zeros(M, C, P, device=device),
            "count": torch.zeros(M, C, dtype=torch.int32, device=device)}


def amsgrad_step(p, grad, mu, nu, nu_max, count, *, lr: float, wd: float,
                 lr_scale: float = 1.0):
    """One step of optax.chain(add_decayed_weights(wd), amsgrad(lr)) and the
    reference's lr_scale on flat params ``p [..., P]`` (the plain K1's
    ``[M, C, P]``, the conv models' ``[M·C, P]``); ``count [...]`` has p's
    shape without the last axis. Returns ``(p, mu, nu, nu_max, count)``."""
    g = grad + wd * p
    mu = (1 - B1) * g + B1 * mu
    nu = (1 - B2) * (g * g) + B2 * nu
    count = torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)
    c = count.float()[..., None]
    nu_max = torch.maximum(nu_max, nu / (1 - B2 ** c))
    u = (mu / (1 - B1 ** c)) / (torch.sqrt(nu_max) + EPS)
    return p + (-lr * u) * lr_scale, mu, nu, nu_max, count


def sgd_step(p, grad, *, lr: float, lr_scale: float = 1.0):
    """One step of optax.sgd(lr) (no weight decay, no state) and the
    reference's lr_scale."""
    return p + (-lr * grad) * lr_scale


def local_steps(grad_fn, x, y, params, opt_state, t_idx, slot, total_w, *,
                batch_size: int, lr: float, wd: float, lr_scale: float = 1.0,
                idx=None, feat_mask=None, optimizer: str = "adam"):
    """The plain local SGD of every (model, client) pair, for any model:
    ``TrainStep._local_sgd``'s contract with the gradient left to
    ``grad_fn(p [M, C, P], xb [M, C, B, *features], yb [M, C, B] int64) ->
    (grad [M, C, P], loss [M, C])``, the mean cross entropy of each pair's
    batch and its gradient. ``x [C, T1, N, *features]``; each step gathers
    its batch rows (contiguous from ``t_idx, slot``, or ``idx``), applies
    ``feat_mask [M, *features]`` (or ``[M, 1]``, a sequence's), and steps the flat params with
    ``amsgrad_step`` / ``sgd_step``. A pair of total weight 0 keeps its
    params and state. Returns ``(client [M, C, P], opt_state, n [M, C],
    mean loss over the S steps [M, C])``, n = ``total_w·N`` (0 where
    inactive)."""
    C, T1, N = x.shape[:3]
    feat = x.shape[3:]
    M, P = params.shape
    B = batch_size
    if idx is None:                  # contiguous: t_idx·N + slot·B + [0, B)
        rows = (t_idx.long() * N + slot.long() * B)[..., None] \
            + torch.arange(B, device=x.device)                # [M, C, S, B]
    else:
        rows = idx.long()
    cidx = torch.arange(C, device=x.device)[None, :, None]
    xf, yf = x.reshape(C, T1 * N, *feat), y.reshape(C, T1 * N)
    if feat_mask is not None:
        feat_mask = feat_mask.reshape(M, 1, 1, *feat_mask.shape[1:])
    p = params[:, None].expand(M, C, P)
    sgd = optimizer == "sgd"
    if not sgd:
        mu, nu, vmax = opt_state["mu"], opt_state["nu"], opt_state["nu_max"]
        count = opt_state["count"]
    losses = []
    for s in range(rows.shape[2]):
        r = rows[:, :, s]                                     # [M, C, B]
        xb = xf[cidx, r]                                      # [M, C, B, ..]
        if feat_mask is not None:
            xb = xb * feat_mask
        grad, loss = grad_fn(p, xb, yf[cidx, r].long())
        losses.append(loss)
        if sgd:
            p = sgd_step(p, grad, lr=lr, lr_scale=lr_scale)
        else:
            p, mu, nu, vmax, count = amsgrad_step(
                p, grad, mu, nu, vmax, count, lr=lr, wd=wd,
                lr_scale=lr_scale)
    active = total_w > 0
    a = active[..., None]
    new_state = {} if sgd else {
        "mu": torch.where(a, mu, opt_state["mu"]),
        "nu": torch.where(a, nu, opt_state["nu"]),
        "nu_max": torch.where(a, vmax, opt_state["nu_max"]),
        "count": torch.where(active, count, opt_state["count"])}
    client = torch.where(a, p, params[:, None])
    n = torch.where(active, total_w * N, torch.zeros_like(total_w))
    return client, new_state, n, torch.stack(losses, -1).mean(-1)


def local_sgd_ref(x, y, params, opt_state, t_idx, slot, total_w, *,
                  hidden: int, batch_size: int, lr: float, wd: float,
                  lr_scale: float = 1.0, idx=None, feat_mask=None,
                  optimizer: str = "adam"):
    """The plain version: ``local_steps`` with the fnn's (or the lr's)
    gradient by autograd, batched over ``[M, C]``; returns a new optimizer
    state."""
    F, P = x.shape[3], params.shape[1]
    K = _classes(F, hidden, P)

    def grad_fn(p, xb, yb):
        with torch.enable_grad():
            pg = p.detach().requires_grad_(True)
            logp = torch.log_softmax(_apply(_unpack(pg, F, hidden, K), xb),
                                     dim=-1)
            loss = -logp.gather(-1, yb[..., None])[..., 0].mean(-1)
            grad, = torch.autograd.grad(loss.sum(), pg)
        return grad, loss.detach()
    return local_steps(grad_fn, x, y, params, opt_state, t_idx, slot,
                       total_w, batch_size=batch_size, lr=lr, wd=wd,
                       lr_scale=lr_scale, idx=idx, feat_mask=feat_mask,
                       optimizer=optimizer)


# csrc/local_sgd.cu's Params: 22 pointers; the eval window's x and y client
# and step strides; M, C, T1, N, F, H, K, B, S, device, sgd; -lr, wd,
# lr_scale, b1, b2, 1 - b1, 1 - b2, eps; padding to 8 bytes
_PARAMS = struct.Struct("=22Q4q11i8f4x")
# the epilogue's zeroed ticket counters, one buffer per (device, stream):
# each launch leaves them zero, so they are allocated once and never reset
_tickets: dict[tuple[int, int], torch.Tensor] = {}


@functools.cache
def _kernel():
    """The C entry point, its ctypes signature set once at first load."""
    fn = library("local_sgd").local_sgd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           index: int) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_cuda or t.get_device() != index:
        raise ValueError(f"{name} must lie on cuda:{index} with x")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"local_sgd runs on cuda or cpu, not "
                         f"{x.device.type}")
    return x.is_cuda


def _ticket(device: torch.device, index: int, stream: int,
            M: int) -> torch.Tensor:
    t = _tickets.get((index, stream))
    if t is None or t.numel() < M:
        t = _tickets[(index, stream)] = torch.zeros(
            max(M, 64), dtype=torch.int32, device=device)
    return t


def _check_fold(x, params, hidden: int, batch_size: int, eval_window,
                eval_out) -> None:
    """Refuse, on any device, an eval that the fused kernel cannot fold
    into the round's launch: a shape ``_folds_eval`` leaves to
    ``eval_cells``, or a window or outputs of another shape or type."""
    if eval_out is None or len(eval_window) != 2 or len(eval_out) != 2:
        raise ValueError("an eval takes eval_window=(x, y) and "
                         "eval_out=(correct, nll)")
    (C, _, N, F), (M, P) = x.shape, params.shape
    H, B = hidden, batch_size
    K = _classes(F, H, P)
    if not _folds_eval(F, H, K, B, N):
        raise ValueError(f"F={F}, H={H}, K={K}, B={B}, N={N}: the eval "
                         f"folds into K1's fused kernel only where its block "
                         f"is eval_cells' (local_sgd._folds_eval); launch "
                         f"eval_cells instead")
    (xw, yw), (correct, nll) = eval_window, eval_out
    for name, t, shape, dt in (("eval x", xw, (C, 2, N, F), torch.float32),
                               ("eval y", yw, (C, 2, N), torch.int32),
                               ("eval correct", correct, (M, C, 2),
                                torch.int32),
                               ("eval nll", nll, (M, C, 2), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: want {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _check_eval(eval_window, eval_out, M: int, C: int, N: int, F: int,
                index: int) -> None:
    """The card's own conditions on a folded eval: devices and layouts."""
    (xw, yw), (correct, nll) = eval_window, eval_out
    for name, t in (("eval x", xw), ("eval y", yw)):
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name} must lie on cuda:{index} with x")
    if (xw.stride(3) != 1 and F > 1) or (xw.stride(2) != F and N > 1) \
            or (yw.stride(2) != 1 and N > 1):
        raise ValueError("the eval window's rows of x [N, F] and of y [N] "
                         "must be contiguous within each (client, step)")
    _check("eval correct", correct, (M, C, 2), torch.int32, index)
    _check("eval nll", nll, (M, C, 2), torch.float32, index)


def _launch(x, y, params, opt_state, t_idx, slot, total_w, *, hidden: int,
            batch_size: int, lr: float, wd: float, lr_scale: float,
            route: str | None, idx, feat_mask, optimizer: str = "adam",
            stats_out=None, aggregate: bool = False, eval_window=None,
            eval_out=None):
    """Check the inputs and launch the kernel of ``route`` (by default
    ``_route``'s), with K2 as its epilogue when ``aggregate`` (the fused
    route only) and the eval of ``params`` on ``eval_window`` into
    ``eval_out`` where they are given (with ``aggregate`` only). Returns
    ``(client, n, loss)``, plus ``(agg, stats)`` when ``aggregate``."""
    rows = (t_idx, slot) if idx is None else (idx,)
    if x.dim() != 4 or params.dim() != 2 or rows[0].dim() != 5 - len(rows):
        raise ValueError("local_sgd takes x [C, T1, N, F], params [M, P] and "
                         "t_idx, slot [M, C, S] or idx [M, C, S, B]")
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer {optimizer!r}: the kernel steps "
                         f"{OPTIMIZERS}")
    C, T1, N, F = x.shape
    M, P = params.shape
    S, H, B = rows[0].shape[2], hidden, batch_size
    K = _classes(F, H, P)
    if not 1 <= B <= N:
        raise ValueError(f"batch {B} is outside [1, N={N}]")
    if route is None:
        route = _route(F, H, K, B, optimizer)
    elif route not in _ROUTES or (
            route == "fused" and _route(F, H, K, B, optimizer) != "fused") \
            or (route == "wide" and not _wide_fits(F, H, K, B, optimizer)) \
            or (route == "split" and not _split_fits(F, H, K, B, optimizer)):
        raise ValueError(f"route {route!r}: the fused kernel takes (F, H, K) "
                         f"in {FUSED_WIDTHS}, B <= {FUSED_MAX_BATCH} with "
                         f"a thread for each of the P + 1 values "
                         f"(fused_threads) and AMSGrad, the wide one F % 4 "
                         f"== 0, a first layer of at most {WIDE_MAX_WIDTH}, "
                         f"B <= "
                         f"{WIDE_ROWS * WIDE_MAX_CLUSTER} within "
                         f"{MAX_SMEM} bytes (wide_smem_bytes), the split one "
                         f"the fnn at F % 4 == 0 within its budget "
                         f"(split_smem_bytes), the general one any shape, "
                         f"the lr and SGD")
    ctas = -(-B // WIDE_ROWS) if route == "wide" \
        else SPLIT_CLUSTER if route == "split" else 1
    if M * C * ctas > MAX_BLOCKS:
        raise ValueError(f"M*C={M * C} pairs of {ctas} blocks exceed "
                         f"{MAX_BLOCKS}")
    if aggregate and route != "fused":
        raise ValueError(f"the {route} route has no FedAvg epilogue: its "
                         f"caller launches K2 (kernels/fedavg.py) itself")
    index = x.get_device()
    if route in ("wide", "split") and x.data_ptr() % 16:
        raise ValueError(f"the {route} route copies x's rows with TMA: x "
                         f"must be 16-byte aligned")
    i32, f32 = torch.int32, torch.float32
    if aggregate and stats_out is None:
        stats_out = torch.empty((M, 3), device=x.device)
    sgd = optimizer == "sgd"
    state = () if sgd else (
        ("mu", opt_state["mu"], (M, C, P), f32),
        ("nu", opt_state["nu"], (M, C, P), f32),
        ("nu_max", opt_state["nu_max"], (M, C, P), f32),
        ("count", opt_state["count"], (M, C), i32))
    for name, t, shape, dt in (
            ("x", x, (C, T1, N, F), f32), ("y", y, (C, T1, N), i32),
            ("params", params, (M, P), f32)) + state + (
            ("total_w", total_w, (M, C), f32),) + (
            (("t_idx", t_idx, (M, C, S), i32), ("slot", slot, (M, C, S), i32))
            if idx is None else (("idx", idx, (M, C, S, B), i32),)) + (
            (("feat_mask", feat_mask, (M, F), f32),)
            if feat_mask is not None else ()) + (
            (("stats_out", stats_out, (M, 3), f32),) if aggregate else ()):
        _check(name, t, shape, dt, index)
    if eval_window is not None:
        _check_eval(eval_window, eval_out, M, C, N, F, index)
        (xw, yw), (ecorrect, enll) = eval_window, eval_out
        ev = (xw.data_ptr(), yw.data_ptr(), ecorrect.data_ptr(),
              enll.data_ptr(), xw.stride(0), xw.stride(1), yw.stride(0),
              yw.stride(1))
    else:
        ev = (0,) * 8
    client = torch.empty((M, C, P), dtype=f32, device=x.device)
    n = torch.empty((M, C), dtype=f32, device=x.device)
    loss = torch.empty((M, C), dtype=f32, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(index)
    agg = torch.empty((M, P), dtype=f32, device=x.device) if aggregate \
        else None
    err = _kernel()(_PARAMS.pack(
        x.data_ptr(), y.data_ptr(), params.data_ptr(),
        *((0,) * 4 if sgd else (t.data_ptr() for _, t, _, _ in state)),
        *((t_idx.data_ptr(), slot.data_ptr(), 0) if idx is None
          else (0, 0, idx.data_ptr())),
        0 if feat_mask is None else feat_mask.data_ptr(), total_w.data_ptr(),
        client.data_ptr(), n.data_ptr(), loss.data_ptr(),
        *((agg.data_ptr(), stats_out.data_ptr(),
           _ticket(x.device, index, stream, M).data_ptr()) if aggregate
          else (0, 0, 0)), *ev,
        M, C, T1, N, F, H, K, B, S, index, int(sgd),
        -lr, wd, lr_scale, B1, B2, 1 - B1, 1 - B2, EPS), _ROUTES[route],
        stream)
    if err == _ERR_SMEM:
        raise ValueError(f"F={F}, H={H}, K={K}, B={B} need more shared "
                         f"memory per block than the kernel may take "
                         f"(csrc/local_sgd.cu states the size and limit)")
    if err != 0:
        raise RuntimeError(f"local_sgd_f32 ({route}, {optimizer}) launch "
                           f"failed: cudaError {err}")
    local_sgd.launches += 1
    if route == "fused":
        local_sgd.fused_launches += 1
    elif route == "wide":
        local_sgd.wide_launches += 1
    elif route == "split":
        local_sgd.split_launches += 1
    if not aggregate:
        return client, n, loss
    local_sgd_fedavg.launches += 1
    if eval_window is not None:
        local_sgd_fedavg.evals += 1
    return client, n, loss, agg, stats_out


def local_sgd(x, y, params, opt_state, t_idx, slot, total_w, *, hidden: int,
              batch_size: int, lr: float, wd: float, lr_scale: float = 1.0,
              route: str | None = None, idx=None, feat_mask=None,
              optimizer: str = "adam"):
    """S local steps of ``optimizer`` (``"adam"``: AMSGrad after weight
    decay; ``"sgd"``) of every (model, client) pair: through a CUDA kernel
    for CUDA tensors (optimizer state updated in place), through
    ``local_sgd_ref`` for CPU tensors. ``hidden``: the fnn's hidden width,
    0 for the lr. ``route`` names the kernel where a comparison needs one
    ("general" takes any shape); by default ``_route`` picks it from the
    shape, model and update. With ``idx`` the batches are gathered rows and
    ``t_idx``, ``slot`` are not read (pass None)."""
    kw = dict(hidden=hidden, batch_size=batch_size, lr=lr, wd=wd,
              lr_scale=lr_scale, idx=idx, feat_mask=feat_mask,
              optimizer=optimizer)
    if not _on_cuda(x):
        return local_sgd_ref(x, y, params, opt_state, t_idx, slot, total_w,
                             **kw)
    client, n, loss = _launch(x, y, params, opt_state, t_idx, slot, total_w,
                              route=route, **kw)
    return client, opt_state, n, loss


local_sgd.launches = 0
local_sgd.fused_launches = 0
local_sgd.wide_launches = 0
local_sgd.split_launches = 0


def wide_clusters(F: int, H: int, K: int, B: int, optimizer: str = "adam",
                  device: int = 0, route: str = "wide") -> int:
    """How many clusters of the wide (or ``route="split"``: the split)
    kernel the card holds at once at this shape
    (``cudaOccupancyMaxActiveClusters``): a launch of P pairs runs in
    ceil(P / that) waves."""
    fn = library("local_sgd").local_sgd_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    out = ctypes.c_int(0)
    err = fn(_ROUTES[route], F, H, K, B, int(optimizer == "sgd"), device,
             ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"local_sgd_clusters ({route}): error {err}")
    return out.value


def local_sgd_fedavg_ref(x, y, params, opt_state, t_idx, slot, total_w, *,
                         eval_window=None, eval_out=None, **kw):
    """The plain version of the fused round: ``local_sgd_ref``, then
    ``fedavg_ref`` of its client stack with ``params`` as prev; with
    ``eval_window`` also ``eval_cells_ref`` of ``params`` (the round's
    input) on it, copied into ``eval_out``."""
    client, state, n, loss = local_sgd_ref(x, y, params, opt_state, t_idx,
                                           slot, total_w, **kw)
    agg, stats = fedavg_ref(client, n, params)
    if eval_window is not None:
        correct, nll = eval_cells_ref(params, *eval_window,
                                      hidden=kw["hidden"],
                                      feat_mask=kw.get("feat_mask"))
        eval_out[0].copy_(correct)
        eval_out[1].copy_(nll)
    return client, state, n, loss, agg, stats


def local_sgd_fedavg(x, y, params, opt_state, t_idx, slot, total_w, *,
                     hidden: int, batch_size: int, lr: float, wd: float,
                     lr_scale: float = 1.0, idx=None, feat_mask=None,
                     stats_out: torch.Tensor | None = None,
                     eval_window=None, eval_out=None):
    """One round of K1 with K2 as its epilogue: ``local_sgd``, then the
    masked FedAvg of its client stack with ``params`` as prev
    (``kernels/fedavg.py``'s function), in ONE launch of the fused kernel
    for CUDA tensors, through ``local_sgd_fedavg_ref`` for CPU tensors.
    Only shapes that ``_route`` sends to the fused kernel are taken: the
    general kernel has no epilogue. ``stats_out``: as ``fedavg``'s.
    ``eval_window = (x [C, 2, N, F], y [C, 2, N])`` (a view such as
    ``x[:, t:t + 2]``) and ``eval_out = (correct, nll)``, each ``[M, C,
    2]`` and contiguous: the same launch evaluates ``params`` (the round's
    INPUT) on the window under ``feat_mask``, as ``eval_cells`` would,
    where ``_folds_eval`` allows it (else ValueError).
    Returns ``(client, opt_state, n, loss, agg [M, P], stats [M, 3])``;
    the optimizer state is updated in place on the card.
    ``local_sgd.launches`` counts the launch too, since K1 runs in it, and
    ``local_sgd_fedavg.evals`` the evals folded into it."""
    kw = dict(hidden=hidden, batch_size=batch_size, lr=lr, wd=wd,
              lr_scale=lr_scale, idx=idx, feat_mask=feat_mask)
    if eval_window is not None:
        _check_fold(x, params, hidden, batch_size, eval_window, eval_out)
    if not _on_cuda(x):
        client, state, n, loss, agg, stats = local_sgd_fedavg_ref(
            x, y, params, opt_state, t_idx, slot, total_w,
            eval_window=eval_window, eval_out=eval_out, **kw)
        if stats_out is not None:
            stats = stats_out.copy_(stats)
        return client, state, n, loss, agg, stats
    client, n, loss, agg, stats = _launch(
        x, y, params, opt_state, t_idx, slot, total_w, route=None,
        stats_out=stats_out, aggregate=True, eval_window=eval_window,
        eval_out=eval_out, **kw)
    return client, opt_state, n, loss, agg, stats


local_sgd_fedavg.launches = 0
local_sgd_fedavg.evals = 0
