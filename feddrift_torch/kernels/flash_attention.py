"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``feddrift_tpu/parallel/pallas_attention.py::flash_attention``
(the Pallas TPU kernel). The kernel is ``csrc/flash_attn_fwd.cu``; its source
notes what it replaces and what bounds it. Layout ``[B, H, L, D]`` as in the
reference.

``flash_attention`` launches the kernel for a CUDA tensor and uses the plain
version, ``flash_attention_ref``, for a CPU tensor. There is no fallback for
a CUDA tensor: the kernel launches or the call raises. The kernel reads
q, k, v through their strides (stride 1 in D, 16-byte aligned rows) and
writes a ``[B, L, H, D]`` buffer, returned as its ``[B, H, L, D]``
transpose view, so heads split off one qkv projection go in and come out
without a copy. Forward only: the training slice adds the backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import NamedTuple

import torch

from feddrift_torch.kernels._checks import needs_grad
from feddrift_torch.kernels.build import library

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535


class LaunchConfig(NamedTuple):
    grid: tuple[int, int]   # (B*H, q tiles of 16 * warps rows)
    warps: int              # per block, 16 query rows each
    block_k: int            # keys per K/V tile; fixed by the build for D


@functools.lru_cache(maxsize=256)
def _launch_config(B: int, H: int, L: int, D: int) -> LaunchConfig:
    """The kernel's launch geometry. Tile sizes depend on (L, D) only, never
    on B or H, so a row's answer does not depend on the batch it is in."""
    warps = 4 if L > 32 else 2 if L > 16 else 1
    return LaunchConfig((B * H, -(-L // (16 * warps))), warps,
                        32 if D == 128 else 64)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Naive masked softmax attention: the plain version of the kernel."""
    L, D = q.shape[-2], q.shape[-1]
    s = torch.matmul(q * (1.0 / math.sqrt(D)), k.transpose(-1, -2))
    if causal:
        pos = torch.arange(L, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1), v)


# csrc/flash_attn_fwd.cu's Params: q, k, v, o pointers; q, k, v strides
# (B, H, L); H, L, D, causal; scale; grid x, grid y, warps, block_k; device
_PARAMS = struct.Struct("=4Q9q4if5i")


@functools.cache
def _kernel():
    """The C entry point, its ctypes signature set once at first load."""
    fn = library("flash_attn_fwd").flash_attn_fwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention ``[B, H, L, D] -> [B, H, L, D]`` through the CUDA kernel
    (CPU tensors: ``flash_attention_ref``, which is differentiable). The
    kernel has no backward yet: on the card a call that needs gradients
    raises."""
    shape = q.shape
    if len(shape) != 4 or shape != k.shape or shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, L, D] shape, got "
                         f"{tuple(shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise TypeError(f"flash_attention takes float32, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not q.is_cuda:
        dev = q.device
        if not dev == k.device == v.device:
            raise ValueError("q, k, v must lie on one device")
        if dev.type == "cpu":
            return flash_attention_ref(q, k, v, causal)
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {dev.type}")
    index = q.get_device()
    if k.get_device() != index or v.get_device() != index:
        raise ValueError("q, k, v must lie on one device")
    if needs_grad(q, k, v):
        raise RuntimeError("flash_attention has no backward on the card: "
                           "call it under torch.no_grad() or on tensors "
                           "that need no gradient")
    B, H, L, D = shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1 or (qp | kp | vp) & 15 or (
            qs[0] | qs[1] | qs[2] | ks[0] | ks[1] | ks[2] | vs[0] | vs[1]
            | vs[2]) & 3:
        raise ValueError("flash_attention needs q, k, v with stride 1 in D "
                         "and 16-byte aligned rows (strides a multiple of 4)")
    cfg = _launch_config(B, H, L, D)
    gx, gy = cfg.grid
    if not (1 <= gx <= MAX_GRID_X and 1 <= gy <= MAX_GRID_Y):
        raise ValueError(f"B*H={gx} and L={L} give a grid outside "
                         f"[1, {MAX_GRID_X}] x [1, {MAX_GRID_Y}]")
    # [B, H, L, D] view of a [B, L, H, D] buffer, which the kernel fills
    out = q.new_empty_strided((B, H, L, D), (L * H * D, D, H * D, 1))
    err = _kernel()(_PARAMS.pack(
        qp, kp, vp, out.data_ptr(), *qs[:3], *ks[:3], *vs[:3], H, L, D,
        causal, 1.0 / math.sqrt(D), gx, gy, cfg.warps, cfg.block_k, index),
        # the current stream's handle, without building a torch.cuda.Stream
        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd_f32 launch failed: cudaError "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
