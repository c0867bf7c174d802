"""Masked, sample-weighted FedAvg of one round (K2): the CUDA kernel's
wrapper and its plain version.

Counterpart of ``feddrift_tpu/resilience/robust_agg.py::agg_mean`` with
the pieces it applies (``weighted_mean``, ``_active_counts``, ``_stats``),
which live here beside the kernel as the plain version's parts. The kernel
is ``csrc/fedavg.cu``; its source notes what bounds it and its design.

Shapes (float32): the client stack ``client [M, C, P]``, weights ``n [M,
C]`` (0 for a client that did not train) and the previous params ``prev
[M, P]``. Returns ``(out [M, P], stats [M, 3])``: the weighted mean of the
clients with ``n > 0``, ``prev`` bitwise where a model has none, and the
(active, rejected, clipped) counts of each model (the mean rejects and
clips nothing).

``fedavg`` launches the kernel for CUDA tensors and takes the plain
version, ``fedavg_ref``, for CPU tensors. There is no fallback for a CUDA
tensor: the kernel launches or the call raises. ``fedavg_ref.cuda_calls``
counts the plain version's calls on CUDA tensors (only a comparison with
the kernel makes them), so a run can show that none carried its rounds.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import torch

from feddrift_torch.kernels.build import library

MAX_MODELS = 65535          # the grid's y extent
# csrc/fedavg.cu's kErrSmem: C weights need more shared memory than a
# block may take (the limit lives in that file only)
_ERR_SMEM = -1


def weighted_mean(client_params, w: torch.Tensor, prev_params):
    """Masked weighted mean over the client axis, the reference's
    operation order: normalise the weights, weight, sum, keep prev where
    the cluster's total weight is 0."""
    denom = w.sum(dim=1)                                   # [M]
    w_norm = w / torch.clamp(denom[:, None], min=1e-12)    # [M, C]
    wb = w_norm.reshape(w_norm.shape + (1,) * (client_params.dim() - 2))
    agg = (client_params * wb).sum(dim=1)
    keep = (denom > 0).reshape((-1,) + (1,) * (prev_params.dim() - 1))
    return torch.where(keep, agg, prev_params)


def _active_counts(n: torch.Tensor):
    """(active mask [M, C] bool, per-cluster active count k [M] int32)."""
    act = n > 0
    return act, act.sum(dim=1).to(torch.int32)


def _stats(k: torch.Tensor) -> torch.Tensor:
    """[M, 3] (active, rejected, clipped): the mean rejects and clips
    nothing."""
    z = torch.zeros_like(k)
    return torch.stack([k, z, z], dim=1).to(torch.float32)


def fedavg_ref(client: torch.Tensor, n: torch.Tensor, prev: torch.Tensor):
    """The plain version: ``(weighted_mean, _stats of the active
    counts)``."""
    if client.is_cuda:
        fedavg_ref.cuda_calls += 1
    _, k = _active_counts(n)
    return weighted_mean(client, n, prev), _stats(k)


fedavg_ref.cuda_calls = 0

# csrc/fedavg.cu's Params: client, n, prev, out, stats pointers; M, C, P,
# device
_PARAMS = struct.Struct("=5Q4i")


@functools.cache
def _kernel():
    """The C entry point, its ctypes signature set once at first load."""
    fn = library("fedavg").fedavg_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    return fn


def fedavg(client: torch.Tensor, n: torch.Tensor, prev: torch.Tensor, *,
           stats_out: torch.Tensor | None = None):
    """``(out [M, P], stats [M, 3])`` of one masked FedAvg: through the
    CUDA kernel for CUDA tensors, through ``fedavg_ref`` for CPU tensors.
    ``stats_out``, a contiguous ``[M, 3]`` float32 tensor (a row of a
    caller's per-round buffer), receives the stats and is returned."""
    if client.dim() != 3 or tuple(n.shape) != tuple(client.shape[:2]) \
            or tuple(prev.shape) != (client.shape[0], client.shape[2]):
        raise ValueError(f"fedavg takes client [M, C, P], n [M, C] and prev "
                         f"[M, P], got {tuple(client.shape)}, "
                         f"{tuple(n.shape)} and {tuple(prev.shape)}")
    M, C, P = client.shape
    if stats_out is not None and (tuple(stats_out.shape) != (M, 3)
                                  or stats_out.dtype != torch.float32):
        raise ValueError(f"stats_out: want float32 ({M}, 3), got "
                         f"{stats_out.dtype} {tuple(stats_out.shape)}")
    if not client.is_cuda:
        if client.device.type != "cpu":
            raise ValueError(f"fedavg runs on cuda or cpu, not "
                             f"{client.device.type}")
        out, stats = fedavg_ref(client, n, prev)
        return out, stats if stats_out is None else stats_out.copy_(stats)
    index = client.get_device()
    if stats_out is None:
        stats_out = torch.empty((M, 3), device=client.device)
    for name, t in (("client", client), ("n", n), ("prev", prev),
                    ("stats_out", stats_out)):
        if t.dtype != torch.float32 or not t.is_cuda \
                or t.get_device() != index or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"cuda:{index}")
    if not (M and C and P) or M > MAX_MODELS:
        raise ValueError(f"fedavg takes 1 <= M <= {MAX_MODELS} and C, P >= "
                         f"1, got ({M}, {C}, {P})")
    out = torch.empty((M, P), device=client.device)
    err = _kernel()(_PARAMS.pack(
        client.data_ptr(), n.data_ptr(), prev.data_ptr(), out.data_ptr(),
        stats_out.data_ptr(), M, C, P, index),
        torch._C._cuda_getCurrentRawStream(index))
    if err == _ERR_SMEM:
        raise ValueError(f"C = {C} client weights need more shared memory "
                         f"per block than the kernel may take "
                         f"(csrc/fedavg.cu states the limit)")
    if err != 0:
        raise RuntimeError(f"fedavg_f32 launch failed: cudaError {err}")
    fedavg.launches += 1
    return out, stats_out


fedavg.launches = 0
