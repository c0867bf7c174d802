"""Eval matrices of the fnn or lr pool (K3): the CUDA kernel's wrapper and
its plain version.

Counterpart of ``feddrift_tpu/core/step.py::TrainStep._acc_matrix_body``
and ``_acc_cells_jit``: every model of the pool on every client's rows of
a window of time steps. The kernel is ``csrc/eval_cells.cu``; its source
notes what bounds it and its design.

Shapes: ``params [M, P]`` (the model's leaves packed in ``param_specs``
order: the fnn's, P = F·H + H + H·K + K, or with ``hidden = 0`` the lr's,
``LogisticRegression``, P = F·K + K), a window ``x [C, G, N, F]`` float32
and ``y [C, G, N]`` int32 of the dataset (any view whose rows ``[N, F]``
are contiguous: ``x[:, t, None]``, ``x[:, t:t + 2]`` or the whole ``[C,
T1, N, F]``), ``feat_mask [M, F]`` (None: ones). The model's outputs are
the logits: the fnn's, or the lr's sigmoid outputs, as the reference
takes them. Returns ``correct [M, C, G]`` int32, the rows whose first
maximal output is the label (``jnp.argmax``'s tie rule, which decides rows
whose sigmoid saturates to 1.0), and ``nll [M, C, G]`` float32, the sums
of ``-log_softmax`` at the label (None unless ``with_nll``).

``eval_cells`` launches a kernel for CUDA tensors and takes the plain
version, ``eval_cells_ref``, for CPU tensors. There is no fallback for a
CUDA tensor: the kernel launches or the call raises. The source holds three
kernels of the one function, and ``_route`` picks one by shape alone
before the launch: the fused kernel for the registry's widths at
``fnn_hidden_dim = 10`` (sine, circle, SEA, ro, susy); the wide
route (a cluster of CTAs a (client, step), the models' first layers side by
side on the tensor cores in 3xTF32) for rows of a multiple of 4 floats:
its resident kernel (32-row tiles staged by TMA once for every model)
where ``wide_smem_bytes`` fits, as at MNIST-4's F = 784, else its
streamed kernel (64-row tiles, F streamed in chunks of 32 with the group's
W0 rows; ``stream_smem_bytes``), as at fmow's F = 3072 (``wide_rows``
says which: 32 or 64); the general one for any other.
``eval_cells.launches`` counts every launch, ``eval_cells.fused_launches``
the fused kernel's, ``eval_cells.wide_launches`` the wide route's and
``eval_cells.stream_launches`` those of its streamed kernel.
``eval_cells_ref.cuda_calls`` counts the plain version's calls on CUDA
tensors (only a comparison with the kernel makes them), so a run can show
that none carried its evals.

The fused round loop takes its evals elsewhere: K1's fused kernel
evaluates its input params in the same launch
(``local_sgd.py::local_sgd_fedavg``'s ``eval_window``), through the cell
this kernel's fused route computes (``csrc/fnn_eval.cuh``), bitwise equal
to this kernel's cells at equal block sizes. ``eval_cells`` takes every
other eval: a time step's last, the per-round path's, ``acc_matrix`` and
``acc_cells``.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from feddrift_torch.kernels.build import library

MAX_BLOCKS = 2 ** 31 - 1
MAX_THREADS = 512
# csrc/eval_cells.cu's kErrSmem: the general kernel needs more shared
# memory per block than it may take (the size and limit live in that file)
_ERR_SMEM = -1
# the (F, H, K) fnn widths the fused kernels are built for: sine and circle,
# SEA, ro and susy at fnn_hidden_dim = 10. K3's and K1's (local_sgd.py
# imports this one: a round folds its eval only where both take the width)
# must match the entry points' dispatch lines, eval_cells_f32's in
# csrc/eval_cells.cu and local_sgd_f32's in csrc/local_sgd.cu
FUSED_WIDTHS = ((2, 10, 2), (3, 10, 2), (5, 10, 2), (18, 10, 2))
_ROUTES = {"general": 0, "fused": 1, "wide": 2}  # eval_cells_f32's route
# The wide kernels of K1 and K3 (csrc/local_sgd.cu, csrc/eval_cells.cu):
# rows a CTA, CTAs a cluster at most, and a block's shared memory
WIDE_ROWS, WIDE_MAX_CLUSTER, MAX_SMEM = 32, 16, 232448
# K3's wide route: the widest first layer it takes (a group's columns at
# most); its streamed kernel's rows a tile, inputs a chunk and chunks in
# flight
WIDE_MAX_WIDTH = 64
STREAM_ROWS, STREAM_CHUNK, STREAM_STAGES = 64, 32, 3


def _wide_stride(F: int) -> int:
    """x's row stride in the wide kernels' shared memory, in floats: the
    least multiple of 4 at or above F that is 4 (mod 8)."""
    s = -(-F // 4) * 4
    return s if s % 8 == 4 else s + 4


def _group(L1: int) -> int:
    """Models whose first layers (``L1`` wide) one pass of K3's wide route
    computes side by side: at most 64 columns and 8 models."""
    return min(8, max(1, WIDE_MAX_WIDTH // L1))


def wide_smem_bytes(F: int, H: int, K: int) -> int:
    """Shared memory of one CTA of the wide route's resident kernel (``H =
    0``: the lr), as ``csrc/eval_cells.cu::eval_wide_smem_bytes`` counts
    it: the mbarrier, 32 rows of x at the padded stride, eight [32, 8]
    tiles of first-layer partials, the second layers of a group of models
    and the warps' totals."""
    tail = H + H * K + K if H else K
    return 16 + 4 * (WIDE_ROWS * _wide_stride(F) + 8 * WIDE_ROWS * 8
                     + _group(H or K) * tail + 16)


def _stream_ns(cols: int) -> int:
    """The streamed kernel's row stride of a W0 chunk, in floats: ``cols``
    rounded up to 8, then to 8 (mod 16)."""
    w = -(-cols // 8) * 8
    return w if w % 16 else w + 8


def stream_smem_bytes(H: int, K: int) -> int:
    """Shared memory of one CTA of the wide route's streamed kernel (``H =
    0``: the lr), whatever F, as ``csrc/eval_cells.cu::
    eval_stream_smem_bytes`` counts it: a ring of 3 stages (64 rows of a
    32-input chunk at stride 36, the widest group's W0 rows of the chunk
    and their mask values at ``_stream_ns``), or the four k-steps' [64,
    columns] partials where they are larger; a group's second layers and
    the warps' totals."""
    L1 = H or K
    cols = _group(L1) * L1
    stage = STREAM_ROWS * _wide_stride(STREAM_CHUNK) \
        + 2 * STREAM_CHUNK * _stream_ns(cols)
    ring = max(STREAM_STAGES * stage, 4 * STREAM_ROWS * (-(-cols // 8) * 8))
    tail = H + H * K + K if H else K
    return 4 * (ring + _group(L1) * tail + 16)


def wide_rows(F: int, H: int, K: int) -> int:
    """The wide route's row tile (``csrc/eval_cells.cu::eval_wide_rows``):
    32 (the resident kernel) where its shared memory fits a block, else 64
    (the streamed kernel) where its does, else 0 (none)."""
    if wide_smem_bytes(F, H, K) <= MAX_SMEM:
        return WIDE_ROWS
    return STREAM_ROWS if stream_smem_bytes(H, K) <= MAX_SMEM else 0


def _route(F: int, H: int, K: int) -> str:
    """Which kernel takes a ``F -> H -> K`` fnn (``H = 0``: the lr): by
    shape alone."""
    if (F, H, K) in FUSED_WIDTHS:
        return "fused"
    if _wide_fits(F, H, K):
        return "wide"
    return "general"


def _wide_fits(F: int, H: int, K: int) -> bool:
    """Whether the wide route takes the shape: 16-byte rows (F % 4 == 0),
    a first layer of at most 64 and one of its kernels' shared memory
    within a block's."""
    return F % 4 == 0 and (H or K) <= WIDE_MAX_WIDTH \
        and wide_rows(F, H, K) > 0


def _threads(N: int) -> int:
    """A block's threads: one row each, a multiple of 32, at most 512."""
    return min(MAX_THREADS, max(32, -(-N // 32) * 32))


def _unpack(p: torch.Tensor, F: int, H: int, K: int):
    """The leaves as views of packed params ``p [.., P]``: the fnn's ``(W0
    [.., F, H], b0 [.., H], W1 [.., H, K], b1 [.., K])``, or with ``H =
    0`` the lr's ``(W [.., F, K], b [.., K])``."""
    if H == 0:
        return p[..., :F * K].unflatten(-1, (F, K)), p[..., F * K:]
    o1, o2, o3 = F * H, F * H + H, F * H + H + H * K
    return (p[..., :o1].unflatten(-1, (F, H)), p[..., o1:o2],
            p[..., o2:o3].unflatten(-1, (H, K)), p[..., o3:])


class _Relu(torch.autograd.Function):
    """``jax.nn.relu``: torch.relu forward (NaN stays NaN) with the
    reference's gradient, ``g * (x > 0)``, which is 0 where x is NaN
    (torch.relu's own gradient passes a NaN's gradient through). On finite
    inputs both gradients are the same values."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x > 0, g, torch.zeros_like(g))


def _apply(leaves, x: torch.Tensor) -> torch.Tensor:
    """The model's outputs ``[.., N, K]`` for ``_unpack``'s leaves (their
    leading axes broadcast with x's) and rows ``x [.., N, F]``: the fnn's
    logits, or the lr's sigmoid outputs."""
    if len(leaves) == 2:
        w, b = leaves
        return torch.sigmoid(x @ w + b.unsqueeze(-2))
    w0, b0, w1, b1 = leaves
    return _Relu.apply(x @ w0 + b0.unsqueeze(-2)) @ w1 + b1.unsqueeze(-2)


def _classes(F: int, H: int, P: int) -> int:
    """K of packed params of size P: an ``F -> H -> K`` fnn, or with ``H =
    0`` an ``F -> K`` lr."""
    K, rest = divmod(P - F * H - H, H + 1) if H else divmod(P, F + 1)
    if K < 1 or rest:
        raise ValueError(f"P={P} is not a {F}->{H}->K fnn" if H
                         else f"P={P} is not an {F}->K lr")
    return K


def _shapes(params, x, y, hidden: int):
    if params.dim() != 2 or x.dim() != 4 or y.dim() != 3 \
            or tuple(y.shape) != tuple(x.shape[:3]):
        raise ValueError(f"eval_cells takes params [M, P], x [C, G, N, F] "
                         f"and y [C, G, N], got {tuple(params.shape)}, "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    F = x.shape[3]
    return F, hidden, _classes(F, hidden, params.shape[1])


def eval_cells_ref(params: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   *, hidden: int, feat_mask: torch.Tensor | None = None,
                   with_nll: bool = True):
    """The plain version: the batched forward, argmax and log-softmax."""
    if params.is_cuda:
        eval_cells_ref.cuda_calls += 1
    F, H, K = _shapes(params, x, y, hidden)
    leaves = [v[:, None, None] for v in _unpack(params, F, H, K)]
    xin = x[None]                                           # [1, C, G, N, F]
    if feat_mask is not None:
        xin = xin * feat_mask[:, None, None, None, :]
    logits = _apply(leaves, xin)                            # [M, C, G, N, K]
    yl = y.long()[None].expand(logits.shape[:-1])
    correct = (logits.argmax(-1) == yl).sum(-1).to(torch.int32)
    if not with_nll:
        return correct, None
    logp = torch.log_softmax(logits, dim=-1)
    return correct, -logp.gather(-1, yl[..., None])[..., 0].sum(-1)


eval_cells_ref.cuda_calls = 0

# csrc/eval_cells.cu's Params: params, fmask, x, y, correct, nll pointers;
# x's client and step strides, y's; M, C, G, N, F, H, K, threads, device
_PARAMS = struct.Struct("=6Q4q9i4x")


@functools.cache
def _kernel():
    """The C entry point, its ctypes signature set once at first load."""
    fn = library("eval_cells").eval_cells_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def _check_out(name, t, shape, dtype, index):
    if t is None:
        return
    if tuple(t.shape) != shape or t.dtype != dtype or not t.is_cuda \
            or t.get_device() != index or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} {shape} on "
                         f"cuda:{index}, got {t.dtype} {tuple(t.shape)}")


def eval_cells(params: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *,
               hidden: int, feat_mask: torch.Tensor | None = None,
               with_nll: bool = True, route: str | None = None,
               correct_out: torch.Tensor | None = None,
               nll_out: torch.Tensor | None = None):
    """``(correct [M, C, G], nll [M, C, G] or None)`` of every model on the
    window: through a CUDA kernel for CUDA tensors, through
    ``eval_cells_ref`` for CPU tensors. ``correct_out`` and ``nll_out``
    (contiguous ``[M, C, G]``, e.g. a slot of a caller's buffer) receive
    the results and are returned. ``hidden``: the fnn's hidden width, 0
    for the lr. ``route`` names the kernel where a comparison needs one
    ("general" takes any width and the lr); by default ``_route`` picks it
    from the shape."""
    F, H, K = _shapes(params, x, y, hidden)
    M, (C, G, N) = params.shape[0], x.shape[:3]
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"eval_cells runs on cuda or cpu, not "
                             f"{x.device.type}")
        correct, nll = eval_cells_ref(params, x, y, hidden=hidden,
                                      feat_mask=feat_mask, with_nll=with_nll)
        if correct_out is not None:
            correct = correct_out.copy_(correct)
        if nll is not None and nll_out is not None:
            nll = nll_out.copy_(nll)
        return correct, nll
    if route is None:
        route = _route(F, H, K)
    elif route not in _ROUTES or (route == "fused"
                                  and _route(F, H, K) != "fused") or (
            route == "wide" and not _wide_fits(F, H, K)):
        raise ValueError(f"route {route!r}: the fused kernel takes (F, H, K) "
                         f"in {FUSED_WIDTHS}, the wide one F % 4 == 0 and a "
                         f"first layer of at most {WIDE_MAX_WIDTH} within "
                         f"{MAX_SMEM} bytes (wide_smem_bytes or "
                         f"stream_smem_bytes), the general one any width")
    index = x.get_device()
    for name, t, dtype in (("params", params, torch.float32),
                           ("x", x, torch.float32), ("y", y, torch.int32)) + (
            (("feat_mask", feat_mask, torch.float32),)
            if feat_mask is not None else ()):
        if t.dtype != dtype or not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name} must be a {dtype} tensor on "
                             f"cuda:{index}")
    if not params.is_contiguous() or (feat_mask is not None and (
            tuple(feat_mask.shape) != (M, F)
            or not feat_mask.is_contiguous())):
        raise ValueError(f"params [M, P] and feat_mask [M={M}, F={F}] must "
                         f"be contiguous")
    if (x.stride(3) != 1 and F > 1) or (x.stride(2) != F and N > 1) \
            or (y.stride(2) != 1 and N > 1):
        raise ValueError("the rows of x [N, F] and of y [N] must be "
                         "contiguous within each (client, step)")
    blocks = M * C * G
    if blocks > MAX_BLOCKS or not (M and C and G):
        raise ValueError(f"M={M}, C={C}, G={G}: {blocks} blocks, want 1 to "
                         f"{MAX_BLOCKS}")
    if route == "wide" and (x.data_ptr() % 16 or (C > 1 and x.stride(0) % 4)
                            or (G > 1 and x.stride(1) % 4)):
        raise ValueError("the wide route copies x's rows with TMA: x and its "
                         "client and step strides must be 16-byte aligned")
    _check_out("correct_out", correct_out, (M, C, G), torch.int32, index)
    _check_out("nll_out", nll_out, (M, C, G), torch.float32, index)
    correct = correct_out if correct_out is not None else torch.empty(
        (M, C, G), dtype=torch.int32, device=x.device)
    nll = None
    if with_nll:
        nll = nll_out if nll_out is not None else torch.empty(
            (M, C, G), device=x.device)
    err = _kernel()(_PARAMS.pack(
        params.data_ptr(), 0 if feat_mask is None else feat_mask.data_ptr(),
        x.data_ptr(), y.data_ptr(), correct.data_ptr(),
        0 if nll is None else nll.data_ptr(), x.stride(0), x.stride(1),
        y.stride(0), y.stride(1), M, C, G, N, F, H, K, _threads(N), index),
        _ROUTES[route],
        torch._C._cuda_getCurrentRawStream(index))
    if err == _ERR_SMEM:
        raise ValueError(f"F={F}, H={H}, K={K} need more shared memory per "
                         f"block than the general kernel may take "
                         f"(csrc/eval_cells.cu states the size and limit)")
    if err != 0:
        raise RuntimeError(f"eval_cells_f32 ({route}) launch failed: "
                           f"cudaError {err}")
    eval_cells.launches += 1
    if route == "fused":
        eval_cells.fused_launches += 1
    elif route == "wide":
        eval_cells.wide_launches += 1
        if wide_rows(F, H, K) == STREAM_ROWS:
            eval_cells.stream_launches += 1
    return correct, nll


eval_cells.launches = 0
eval_cells.fused_launches = 0
eval_cells.wide_launches = 0
eval_cells.stream_launches = 0
