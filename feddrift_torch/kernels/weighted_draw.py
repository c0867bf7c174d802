"""Weighted draw of a round's batch rows (K4): the CUDA kernel's wrapper
and its plain version.

Counterpart of ``feddrift_tpu/core/step.py::weight_cdf`` and
``inverse_cdf_draw`` as ``TrainStep._local_sgd`` applies them to every
(model, client) pair when the step samples by per-sample weight (KUE's
Poisson bootstrap). The kernel is ``csrc/weighted_draw.cu``; its source
notes what bounds it and its design.

Shapes: ``time_w [M, C, T1]`` (already masked by the round's client
sampling), ``sample_w [M, C, N]`` and uniforms ``u [M, C, *D]`` in [0, 1),
all float32. A pair's probabilities are ``p[t, n] = active·w_t[t]·s_n[n]``
over its ``T1·N`` rows (``active``: its time weights sum above 0), made
uniform where they sum to 0, as the reference does for an inactive pair;
each uniform becomes the row ``searchsorted(cdf, u, side="right")`` of the
normalised inclusive cumsum, clipped to ``[0, T1·N - 1]``. Returns ``idx
[M, C, *D]`` int32, row ``t·N + n`` of the pair's client.

``weighted_draw`` launches the kernel for CUDA tensors and takes the plain
version, ``weighted_draw_ref`` (``torch.cumsum`` + ``torch.searchsorted``),
for CPU tensors. There is no fallback for a CUDA tensor: the kernel
launches or the call raises.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from feddrift_torch.kernels.build import library

MAX_BLOCKS = 2 ** 31 - 1
# csrc/weighted_draw.cu's kErrSmem: T1·N rows need more shared memory than
# a block may take (the limit lives in that file only)
_ERR_SMEM = -1


def _shapes(time_w, sample_w, u):
    if time_w.dim() != 3 or sample_w.dim() != 3 or u.dim() < 2 \
            or time_w.shape[:2] != sample_w.shape[:2] \
            or u.shape[:2] != time_w.shape[:2]:
        raise ValueError(f"weighted_draw takes time_w [M, C, T1], sample_w "
                         f"[M, C, N] and u [M, C, ...], got "
                         f"{tuple(time_w.shape)}, {tuple(sample_w.shape)} "
                         f"and {tuple(u.shape)}")
    return time_w.shape[2], sample_w.shape[2]


def weighted_cdf_ref(time_w: torch.Tensor,
                     sample_w: torch.Tensor) -> torch.Tensor:
    """The normalised inclusive cumsum ``[M, C, T1·N]`` of every pair's
    probabilities (the reference's ``weight_cdf`` of its ``probs``)."""
    M, C, T1 = time_w.shape
    active = (time_w.sum(-1) > 0).to(time_w.dtype)[..., None, None]
    p = (active * (time_w[..., :, None] * sample_w[..., None, :])).reshape(
        M, C, -1)
    p = torch.where(p.sum(-1, keepdim=True) > 0, p, torch.ones_like(p))
    cdf = torch.cumsum(p, -1)
    return cdf / cdf[..., -1:]


def weighted_draw_ref(time_w: torch.Tensor, sample_w: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """The plain version: ``weighted_cdf_ref``, then ``searchsorted``."""
    T1, N = _shapes(time_w, sample_w, u)
    cdf = weighted_cdf_ref(time_w, sample_w)
    idx = torch.searchsorted(cdf, u.reshape(*u.shape[:2], -1).contiguous(),
                             right=True, out_int32=True)
    return idx.clamp_(max=T1 * N - 1).view(u.shape)


# csrc/weighted_draw.cu's Params: time_w, sample_w, u, idx, cdf_out
# pointers; pairs, T1, N, D; device
_PARAMS = struct.Struct("=5Q5i4x")


@functools.cache
def _kernel():
    """The C entry point, its ctypes signature set once at first load."""
    fn = library("weighted_draw").weighted_draw_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    return fn


def weighted_draw(time_w: torch.Tensor, sample_w: torch.Tensor,
                  u: torch.Tensor, *, cdf_out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Every pair's batch rows ``idx [M, C, *D]`` int32 for the uniforms
    ``u``: through the CUDA kernel for CUDA tensors, through
    ``weighted_draw_ref`` for CPU tensors. ``cdf_out``, a CUDA ``[M, C,
    T1·N]`` float32 buffer, also receives the kernel's cdf (for checks)."""
    T1, N = _shapes(time_w, sample_w, u)
    if not u.is_cuda:
        if u.device.type != "cpu":
            raise ValueError(f"weighted_draw runs on cuda or cpu, not "
                             f"{u.device.type}")
        return weighted_draw_ref(time_w, sample_w, u)
    M, C = u.shape[:2]
    index = u.get_device()
    for name, t in (("time_w", time_w), ("sample_w", sample_w), ("u", u)) \
            + ((("cdf_out", cdf_out),) if cdf_out is not None else ()):
        if t.dtype != torch.float32 or not t.is_cuda \
                or t.get_device() != index or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"cuda:{index}")
    if cdf_out is not None and tuple(cdf_out.shape) != (M, C, T1 * N):
        raise ValueError(f"cdf_out: want ({M}, {C}, {T1 * N}), got "
                         f"{tuple(cdf_out.shape)}")
    if M * C > MAX_BLOCKS:
        raise ValueError(f"M*C={M * C} blocks exceed {MAX_BLOCKS}")
    idx = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    err = _kernel()(_PARAMS.pack(
        time_w.data_ptr(), sample_w.data_ptr(), u.data_ptr(), idx.data_ptr(),
        0 if cdf_out is None else cdf_out.data_ptr(), M * C, T1, N,
        u[0, 0].numel(), index), torch._C._cuda_getCurrentRawStream(index))
    if err == _ERR_SMEM:
        raise ValueError(f"T1·N = {T1 * N} rows need more shared memory per "
                         f"block than the kernel may take "
                         f"(csrc/weighted_draw.cu states the limit)")
    if err != 0:
        raise RuntimeError(f"weighted_draw_f32 launch failed: cudaError {err}")
    weighted_draw.launches += 1
    return idx


weighted_draw.launches = 0
