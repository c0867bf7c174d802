"""Per-row Dense of the serving forward: the CUDA kernel's wrapper and its
plain version.

``y[b] = x[b] @ W[b] (+ bias[b])`` with x ``[B, L, in]``, W ``[B, in, out]``
(flax's ``[in, out]`` kernel layout, one per row) and bias ``[B, out]``, all
float32. The counterpart of the reference's ``nn.Dense`` vmapped over the
per-row gathered params of a mixed-model micro-batch
(``feddrift_tpu/models/transformer.py``). The kernel is
``csrc/dense_rows.cu``; its source notes what bounds it and its design.

Two routes, picked by shape alone (``_launch_config``): for L > 1 the
product runs on the tensor cores at float32 accuracy (3xTF32 ``mma.sync``,
a ``cp.async`` ring of x and W tiles), for L = 1 (the lm_head's last
position) as a per-row GEMV that streams W once. The route, the tiles and
the k order depend on ``(L, in, out)`` only, never on B, so a row's answer
is bitwise the same in any batch, B = 1 included: served answers do not
depend on the micro-batch a request lands in. ``dense_rows`` launches the
kernel for CUDA tensors and takes the plain version, ``dense_rows_ref``,
for CPU tensors. There is no fallback for a CUDA tensor: the kernel
launches or the call raises. The kernel has no backward, so it refuses
inputs that need a gradient.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from feddrift_torch.kernels._checks import needs_grad
from feddrift_torch.kernels.build import library

MAX_GRID_X = 2 ** 31 - 1
# 16 x 64 tiles unless a row then has too few of them for a micro-batch of
# FILL_ROWS rows (the mean served micro-batch) to fill the card's SMs
FILL_ROWS, SMS = 8, 132
_ROUTES = {"gemv": 0, "mma": 1}     # csrc/dense_rows.cu's kRoute*


class LaunchConfig(NamedTuple):
    route: str      # "mma" (3xTF32 tensor cores) or "gemv" (L = 1)
    tile_l: int     # positions of a block's output tile
    tile_out: int   # outputs of a block's output tile
    warps: int      # warps of a block; they share out the k loop


@functools.lru_cache(maxsize=64)
def _launch_config(L: int, in_: int, out: int) -> LaunchConfig:
    """The kernel's route and tiles: from the layer's shape only, never
    from B. The k order follows from them: in the mma route warp w sums
    k8 slice w of every 32-deep k tile, in the gemv route k = w, w + 8,
    ...; both add the warps' partials in warp order, then the bias."""
    del in_                     # one k tile serves every depth
    if L == 1:
        return LaunchConfig("gemv", 1, 64, 8)
    wide = -(-L // 16) * -(-out // 64) * FILL_ROWS >= SMS
    return LaunchConfig("mma", 16, 64 if wide else 32, 4)


def grid_blocks(B: int, L: int, out: int, cfg: LaunchConfig) -> int:
    """Blocks of one launch: one per (row, position tile, output tile)."""
    return B * -(-L // cfg.tile_l) * -(-out // cfg.tile_out)


def dense_rows_ref(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: one ``[L, in] @ [in, out]`` product a row, then
    the bias. Every row takes a product of the same shape, as every row of
    the kernel takes the same tiles, so a row's answer is bitwise the same
    at any B; one ``torch.bmm`` over the batch is not, since the CPU's
    BLAS may pick another kernel at another batch count."""
    y = torch.stack([torch.mm(xb, wb) for xb, wb in zip(x, w)]) \
        if x.shape[0] else x.new_empty((0, x.shape[1], w.shape[2]))
    return y if bias is None else y + bias[:, None, :]


# csrc/dense_rows.cu's Params: x, w, bias, y pointers; x strides (B, L), W
# strides (B, in), bias stride B; B; L, in, out; route, tile_l, tile_out,
# warps; device
_PARAMS = struct.Struct("=4Q6q8i")


@functools.cache
def _kernel():
    """The C entry point, its ctypes signature set once at first load."""
    fn = library("dense_rows").dense_rows_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    return fn


def dense_rows(x: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """``[B, L, in] @ [B, in, out] (+ [B, out]) -> [B, L, out]`` through the
    CUDA kernel (CPU tensors: ``dense_rows_ref``)."""
    tensors = (x, w) if bias is None else (x, w, bias)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"dense_rows takes x [B, L, in] and w [B, in, out], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    B, L, n_in = x.shape
    n_out = w.shape[2]
    if bias is not None and tuple(bias.shape) != (B, n_out):
        raise ValueError(f"bias: want ({B}, {n_out}), got "
                         f"{tuple(bias.shape)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"dense_rows takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    if not x.is_cuda:
        if any(t.device != x.device for t in tensors):
            raise ValueError("x, w and bias must lie on one device")
        if x.device.type == "cpu":
            return dense_rows_ref(x, w, bias)
        raise ValueError(f"dense_rows runs on cuda or cpu, not "
                         f"{x.device.type}")
    index = x.get_device()
    if any(not t.is_cuda or t.get_device() != index for t in tensors):
        raise ValueError("x, w and bias must lie on one device")
    if needs_grad(*tensors):
        raise RuntimeError("dense_rows has no backward: call it under "
                           "torch.no_grad() or on tensors that need no "
                           "gradient")
    if (n_in > 1 and x.stride(2) != 1) or (n_out > 1 and w.stride(2) != 1) \
            or (bias is not None and n_out > 1 and bias.stride(1) != 1):
        raise ValueError("dense_rows needs stride 1 in the last dimension "
                         "of x, w and bias")
    cfg = _launch_config(L, n_in, n_out)
    blocks = grid_blocks(B, L, n_out, cfg)
    if blocks > MAX_GRID_X:
        raise ValueError(f"B={B}, L={L}, out={n_out} give {blocks} blocks, "
                         f"more than the grid's {MAX_GRID_X}")
    y = torch.empty((B, L, n_out), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    err = _kernel()(_PARAMS.pack(
        x.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(),
        y.data_ptr(), x.stride(0), x.stride(1), w.stride(0), w.stride(1),
        0 if bias is None else bias.stride(0), B, L, n_in, n_out,
        _ROUTES[cfg.route], *cfg[1:], index),
        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"dense_rows_f32 launch failed: cudaError {err}")
    dense_rows.launches += 1
    return y


dense_rows.launches = 0
