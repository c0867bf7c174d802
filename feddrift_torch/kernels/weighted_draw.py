"""Weighted draw of a round's batch rows (K4): the CUDA kernels' wrappers
and their plain versions.

Counterpart of ``feddrift_tpu/core/step.py::weight_cdf`` and
``inverse_cdf_draw`` as ``TrainStep._local_sgd`` applies them to every
(model, client) pair when the step samples by per-sample weight (KUE's
Poisson bootstrap). The kernels are in ``csrc/weighted_draw.cu``; its
source notes what bounds them and their design. The draw is split in two:

- ``weighted_cdf`` (K4a, once a time step): from the step's unmasked
  ``time_w [M, C, T1]`` and ``sample_w [M, C, N]``, every pair's
  normalised inclusive cumsum ``cdf [M, C, T1·N]`` float32 of its
  probabilities ``p[t, n] = active·w_t[t]·s_n[n]`` (``active``: its time
  weights sum above 0), made uniform where they sum to 0, as the reference
  does for an inactive pair.
- ``weighted_search`` (K4b, once a round): from ``cdf``, the round's
  masked total weights ``total_w [M, C]`` and uniforms ``u [M, C, *D]`` in
  [0, 1), the rows ``idx [M, C, *D]`` int32: ``searchsorted(cdf, u,
  side="right")`` clipped to ``[0, T1·N - 1]``, over the uniform cdf
  ``(i + 1) / (T1·N)`` where ``total_w`` is 0 (a client the round's mask
  leaves out, or an inactive pair). Row ``t·N + n`` of the pair's client.

A client mask only zeroes an unsampled client's pair weights, so the rows
of every round of a step follow from the one cdf of the step's unmasked
weights. ``weighted_draw`` composes the two for one set of weights (tests,
``chip_smoke.py``).

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (``weighted_cdf_ref``, ``weighted_search_ref``: ``torch.cumsum``,
``torch.searchsorted``) for CPU tensors. There is no fallback for a CUDA
tensor: the kernel launches or the call raises. ``weighted_cdf.launches``
and ``weighted_search.launches`` count launches; the plain versions'
``cuda_calls`` count their calls on CUDA tensors (only a comparison with
the kernels makes them).
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


def _weight_shapes(time_w, sample_w):
    if time_w.dim() != 3 or sample_w.dim() != 3 \
            or time_w.shape[:2] != sample_w.shape[:2]:
        raise ValueError(f"weighted_cdf takes time_w [M, C, T1] and sample_w "
                         f"[M, C, N], got {tuple(time_w.shape)} and "
                         f"{tuple(sample_w.shape)}")
    return time_w.shape[2], sample_w.shape[2]


def _search_shapes(cdf, total_w, u):
    if cdf.dim() != 3 or tuple(total_w.shape) != tuple(cdf.shape[:2]) \
            or u.dim() < 2 or u.shape[:2] != cdf.shape[:2]:
        raise ValueError(f"weighted_search takes cdf [M, C, L], total_w "
                         f"[M, C] and u [M, C, ...], got "
                         f"{tuple(cdf.shape)}, {tuple(total_w.shape)} and "
                         f"{tuple(u.shape)}")
    return cdf.shape[2]


def _on_cuda_or_cpu(name: str, t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device.type}")
    return t.is_cuda


def _check(index: int, *named) -> None:
    for name, t, dtype in named:
        if t.dtype != dtype or not t.is_cuda or t.get_device() != index \
                or not t.is_contiguous():
            kind = str(dtype).removeprefix("torch.")
            raise ValueError(f"{name} must be a contiguous {kind} tensor on "
                             f"cuda:{index}")


def _raise_for(err: int, L: int, fn: str) -> None:
    if err == _ERR_SMEM:
        raise ValueError(f"T1·N = {L} rows need more shared memory per block "
                         f"than the kernel may take (csrc/weighted_draw.cu "
                         f"states the limit)")
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")


def weighted_cdf_ref(time_w: torch.Tensor,
                     sample_w: torch.Tensor) -> torch.Tensor:
    """The normalised inclusive cumsum ``[M, C, T1·N]`` of every pair's
    probabilities (the reference's ``weight_cdf`` of its ``probs``)."""
    if time_w.is_cuda:
        weighted_cdf_ref.cuda_calls += 1
    M, C, T1 = time_w.shape
    active = (time_w.sum(-1) > 0).to(time_w.dtype)[..., None, None]
    p = (active * (time_w[..., :, None] * sample_w[..., None, :])).reshape(
        M, C, -1)
    p = torch.where(p.sum(-1, keepdim=True) > 0, p, torch.ones_like(p))
    cdf = torch.cumsum(p, -1)
    return cdf / cdf[..., -1:]


weighted_cdf_ref.cuda_calls = 0


def weighted_search_ref(cdf: torch.Tensor, total_w: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """The plain version of the search: ``searchsorted(right=True)`` of
    each pair's uniforms in its cdf, or in the uniform cdf ``(i + 1) / L``
    (``cumsum`` of ones over L) where ``total_w`` is 0; clipped to L - 1."""
    if cdf.is_cuda:
        weighted_search_ref.cuda_calls += 1
    L = _search_shapes(cdf, total_w, u)
    ones = torch.cumsum(torch.ones(L, device=cdf.device), 0)
    cdf = torch.where((total_w > 0)[..., None], cdf, ones / ones[-1])
    idx = torch.searchsorted(cdf.contiguous(),
                             u.reshape(*u.shape[:2], -1).contiguous(),
                             right=True, out_int32=True)
    return idx.clamp_(max=L - 1).view(u.shape)


weighted_search_ref.cuda_calls = 0


def weighted_draw_ref(time_w: torch.Tensor, sample_w: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """The plain version of the whole draw for one set of weights:
    ``weighted_cdf_ref``, then ``searchsorted``."""
    T1, N = _weight_shapes(time_w, sample_w)
    cdf = weighted_cdf_ref(time_w, sample_w)
    idx = torch.searchsorted(cdf, u.reshape(*u.shape[:2], -1).contiguous(),
                             right=True, out_int32=True)
    return idx.clamp_(max=T1 * N - 1).view(u.shape)


# csrc/weighted_draw.cu's CdfParams: time_w, sample_w, cdf pointers;
# pairs, T1, N, device. SearchParams: cdf, total_w, u, idx pointers;
# pairs, L, D, device.
_CDF_PARAMS = struct.Struct("=3Q4i")
_SEARCH_PARAMS = struct.Struct("=4Q4i")


@functools.cache
def _kernel(name: str):
    """A C entry point, its ctypes signature set once at first load."""
    fn = getattr(library("weighted_draw"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    return fn


def weighted_cdf(time_w: torch.Tensor, sample_w: torch.Tensor, *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Every pair's cdf ``[M, C, T1·N]`` float32 (K4a): through the CUDA
    kernel for CUDA tensors, written into ``out`` where given, through
    ``weighted_cdf_ref`` for CPU tensors."""
    T1, N = _weight_shapes(time_w, sample_w)
    M, C = time_w.shape[:2]
    if out is not None and (tuple(out.shape) != (M, C, T1 * N)
                            or out.dtype != torch.float32):
        raise ValueError(f"out: want float32 ({M}, {C}, {T1 * N}), got "
                         f"{out.dtype} {tuple(out.shape)}")
    if not _on_cuda_or_cpu("weighted_cdf", time_w):
        cdf = weighted_cdf_ref(time_w, sample_w)
        return cdf if out is None else out.copy_(cdf)
    index = time_w.get_device()
    if out is None:
        out = torch.empty((M, C, T1 * N), device=time_w.device)
    _check(index, ("time_w", time_w, torch.float32),
           ("sample_w", sample_w, torch.float32), ("out", out, torch.float32))
    if M * C > MAX_BLOCKS:
        raise ValueError(f"M*C={M * C} blocks exceed {MAX_BLOCKS}")
    err = _kernel("weighted_cdf_f32")(_CDF_PARAMS.pack(
        time_w.data_ptr(), sample_w.data_ptr(), out.data_ptr(), M * C, T1, N,
        index), torch._C._cuda_getCurrentRawStream(index))
    _raise_for(err, T1 * N, "weighted_cdf_f32")
    weighted_cdf.launches += 1
    return out


weighted_cdf.launches = 0


def weighted_search(cdf: torch.Tensor, total_w: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """Every pair's batch rows ``idx [M, C, *D]`` int32 for the uniforms
    ``u`` (K4b): through the CUDA kernel for CUDA tensors, through
    ``weighted_search_ref`` for CPU tensors."""
    L = _search_shapes(cdf, total_w, u)
    if not _on_cuda_or_cpu("weighted_search", u):
        return weighted_search_ref(cdf, total_w, u)
    M, C = u.shape[:2]
    index = u.get_device()
    _check(index, ("cdf", cdf, torch.float32),
           ("total_w", total_w, torch.float32), ("u", u, torch.float32))
    if M * C > MAX_BLOCKS:
        raise ValueError(f"M*C={M * C} blocks exceed {MAX_BLOCKS}")
    idx = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    if idx.numel() == 0:
        return idx
    err = _kernel("weighted_search_f32")(_SEARCH_PARAMS.pack(
        cdf.data_ptr(), total_w.data_ptr(), u.data_ptr(), idx.data_ptr(),
        M * C, L, u[0, 0].numel(), index),
        torch._C._cuda_getCurrentRawStream(index))
    _raise_for(err, L, "weighted_search_f32")
    weighted_search.launches += 1
    return idx


weighted_search.launches = 0


def weighted_draw(time_w: torch.Tensor, sample_w: torch.Tensor,
                  u: torch.Tensor, *, cdf_out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """The whole draw for one set of weights: ``weighted_cdf`` (into
    ``cdf_out`` where given), then ``weighted_search`` with the weights'
    own totals. Returns ``idx [M, C, *D]`` int32."""
    _weight_shapes(time_w, sample_w)
    if u.dim() < 2 or u.shape[:2] != time_w.shape[:2]:
        raise ValueError(f"weighted_draw takes u [M, C, ...] with time_w's "
                         f"[M, C], got {tuple(u.shape)} and "
                         f"{tuple(time_w.shape)}")
    cdf = weighted_cdf(time_w, sample_w, out=cdf_out)
    return weighted_search(cdf, time_w.sum(-1), u)
