"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``feddrift_tpu/parallel/pallas_attention.py::flash_attention``
(the Pallas TPU kernel). The kernel is ``csrc/flash_attn_fwd.cu``; its source
notes what it replaces and what bounds it. Layout ``[B, H, L, D]`` as in the
reference.

``flash_attention`` launches the kernel for a CUDA tensor and uses the plain
version, ``flash_attention_ref``, for a CPU tensor. There is no fallback for
a CUDA tensor: the kernel launches or the call raises. Forward only: the
training slice adds the backward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from feddrift_torch.kernels.build import library

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)
_MAX_GRID_Y = 65535


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Naive masked softmax attention: the plain version of the kernel."""
    L, D = q.shape[-2], q.shape[-1]
    s = torch.matmul(q * (1.0 / math.sqrt(D)), k.transpose(-1, -2))
    if causal:
        pos = torch.arange(L, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, L, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for t in (q, k, v):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention takes float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError("q, k, v must lie on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention ``[B, H, L, D] -> [B, H, L, D]`` through the CUDA kernel
    (CPU tensors: ``flash_attention_ref``)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device.type}")
    B, H, L, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if not 1 <= B * H <= _MAX_GRID_Y or L < 1:
        raise ValueError(f"B*H={B * H} must be in [1, {_MAX_GRID_Y}] and "
                         f"L={L} >= 1")
    fn = library("flash_attn_fwd").flash_attn_fwd_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B * H, L, D, int(causal), 1.0 / math.sqrt(D),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd_f32 launch failed: cudaError "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
