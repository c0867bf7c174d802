"""A whole LSTM layer's recurrence: the CUDA kernels' wrappers, their plain
versions, ``layer_refusal`` (which layers the kernels take) and
``lstm_layer``, the differentiable op ``models/base.py::pair_lstm`` calls.

The JAX package has no Pallas kernel here: flax's ``nn.RNN(
nn.OptimizedLSTMCell)`` (``feddrift_tpu/models/rnn.py``) is a ``lax.scan``
that XLA runs as one program. The kernels are in ``csrc/lstm_layer.cu``,
whose source notes what bounds them and their design.

- ``lstm_layer_fwd(zx [K, N, L, 4H], wh [K, H, 4H], b [K, 4H]) -> (h, c,
  gates)``: every step of K pairs' layers from a zero carry, the step's
  pre-activations flax's ``(h·W_h + b) + x·W_i`` with ``zx`` the input
  products of all steps. ``h`` is ``[K, N, L, H]``, or ``[K, N, H]`` (the
  last step) where not ``h_all``; ``c [K, N, L, H]`` and the activated
  ``gates [K, N, L, 4H]`` (order i, f, g, o) are written only where
  ``state`` (a backward needs them), else None.
- ``lstm_layer_bwd(dH, gates, c, wh) -> dZ [K, N, L, 4H]``: the gradient of
  every step's pre-activations, from the gradient of every step's output
  (``dH [K, N, L, H]``) or of the last one (``[K, N, H]``).

Each wrapper launches its kernel (float32) for CUDA tensors and takes its
plain version (``lstm_layer_fwd_ref``, ``lstm_layer_bwd_ref``: a loop of
batched products and the plain cell, ``kernels/lstm_cell.py``) for CPU
tensors. There is no fallback for a CUDA tensor: the kernel launches or the
call raises. ``lstm_layer_fwd.launches`` and ``lstm_layer_bwd.launches``
count launches; the plain versions' ``cuda_calls`` count their calls on
CUDA tensors (only a comparison with the kernels makes them).

``lstm_layer`` joins the two in an ``autograd.Function``: its backward is
the backward kernel, then plain products: dW_h as one batched product of
the previous steps' h (h_{-1} = 0) stacked over the N·L rows with dZ, db
as dZ summed, and dZ itself as the gradient of ``zx`` (whose product,
outside, gives dW_i and dx through autograd). Under ``no_grad`` (the
evals) the forward writes only h.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from feddrift_torch.kernels._checks import needs_grad
from feddrift_torch.kernels.build import library
from feddrift_torch.kernels.lstm_cell import (lstm_cell_bwd_ref,
                                              lstm_cell_fwd_ref)

# H of the kernels' instances: a cluster of H / 32 CTAs, each 32 units
LAYER_HIDDEN = (32, 64, 128, 256)
LAYER_ROWS = 32                     # rows of a cluster


def layer_refusal(dtype: torch.dtype, H: int) -> str | None:
    """Why the layer kernels do not take a layer of width ``H`` in
    ``dtype``, or None where they do. A refused layer takes the per-step
    route (``pair_lstm``'s loop, the cell kernels on the card). Decided on
    the type and width alone, so the CPU takes the same route as the card
    (through the plain versions)."""
    if dtype != torch.float32:
        return (f"{dtype}: the layer kernels are float32 (a float64 slice "
                f"of W_h, 256 KiB at H 256, fits no 8-CTA cluster's shared "
                f"memory beside its buffers)")
    if H not in LAYER_HIDDEN:
        return (f"H {H}: the layer kernels hold W_h in a cluster of H / 32 "
                f"CTAs and take H in {LAYER_HIDDEN} (WordLSTM's 670 "
                f"exceeds a cluster's shared memory)")
    return None


def lstm_layer_fwd_ref(zx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
                       state: bool = True, h_all: bool = True):
    """The plain forward: ``(h, c, gates)`` as ``lstm_layer_fwd`` returns
    them, step by step: ``baddbmm(b, h, wh) + zx_t`` and the plain cell."""
    if zx.is_cuda:
        lstm_layer_fwd_ref.cuda_calls += 1
    K, N, L, G = zx.shape
    H = G // 4
    h = zx.new_zeros(K, N, H)
    c = zx.new_zeros(K, N, H)
    hs, cs, gs = [], [], []
    for zt in zx.unbind(2):
        z = torch.baddbmm(b[:, None], h, wh) + zt
        h, c, gates = lstm_cell_fwd_ref(z, c)
        hs.append(h)
        cs.append(c)
        gs.append(gates)
    if not state:
        return (torch.stack(hs, 2) if h_all else h), None, None
    return (torch.stack(hs, 2) if h_all else h), torch.stack(cs, 2), \
        torch.stack(gs, 2)


def lstm_layer_bwd_ref(dH: torch.Tensor, gates: torch.Tensor,
                       c: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The plain backward: ``dZ``, step by step from the last:
    ``dh_t = dH_t + bmm(dz_{t+1}, wh^T)`` and the plain cell's backward."""
    if dH.is_cuda:
        lstm_layer_bwd_ref.cuda_calls += 1
    L = gates.shape[2]
    dc = torch.zeros_like(c[:, :, 0])
    dzs = [None] * L
    for t in range(L - 1, -1, -1):
        if dH.dim() == 4:
            dh = dH[:, :, t]
        else:
            dh = dH if t == L - 1 else torch.zeros_like(dc)
        if t < L - 1:
            dh = dh + torch.bmm(dzs[t + 1], wh.mT)
        prev = c[:, :, t - 1] if t else torch.zeros_like(dc)
        dzs[t], dc = lstm_cell_bwd_ref(dh, dc, gates[:, :, t], prev,
                                       c[:, :, t])
    return torch.stack(dzs, 2)


lstm_layer_fwd_ref.cuda_calls = 0
lstm_layer_bwd_ref.cuda_calls = 0


@functools.cache
def _entry(name: str):
    """A C entry point of ``csrc/lstm_layer.cu``, its signature set once."""
    fn = getattr(library("lstm_layer"), name)
    fn.restype = ctypes.c_int
    pointers = 6 if name == "lstm_layer_fwd_f32" else 5
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _check(name: str, tensors: dict, shapes: dict) -> int:
    """The device index of a call whose tensors have ``shapes``; raises on a
    shape, type, device or layout the kernel does not take."""
    index = next(iter(tensors.values())).get_device()
    for key, t in tensors.items():
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} must be {list(shapes[key])}, "
                             f"got {list(t.shape)}")
        if t.dtype != torch.float32 or not t.is_cuda \
                or t.get_device() != index or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: every tensor must be a contiguous, "
                             f"16-byte aligned float32 tensor on "
                             f"cuda:{index}, {key} is {t.dtype} on "
                             f"{t.device}")
    return index


def _dims(name: str, zx_or_gates: torch.Tensor) -> tuple[int, int, int, int]:
    if zx_or_gates.dim() != 4 or zx_or_gates.shape[3] % 4:
        raise ValueError(f"{name}: takes [K, N, L, 4H], got "
                         f"{list(zx_or_gates.shape)}")
    K, N, L, G = zx_or_gates.shape
    H = G // 4
    why = layer_refusal(zx_or_gates.dtype, H)
    if why is not None or not (K and N and L):
        raise ValueError(f"{name}: {why or f'K, N, L >= 1, got {K, N, L}'}")
    return K, N, L, H


def lstm_layer_fwd(zx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
                   state: bool = True, h_all: bool = True):
    """``(h, c, gates)`` of a whole layer (module docstring): the CUDA
    kernel for CUDA tensors, ``lstm_layer_fwd_ref`` for CPU tensors."""
    if not zx.is_cuda:
        return lstm_layer_fwd_ref(zx, wh, b, state, h_all)
    K, N, L, H = _dims("lstm_layer_fwd", zx)
    index = _check("lstm_layer_fwd", {"zx": zx, "wh": wh, "b": b},
                   {"zx": (K, N, L, 4 * H), "wh": (K, H, 4 * H),
                    "b": (K, 4 * H)})
    h = zx.new_empty((K, N, L, H) if h_all else (K, N, H))
    c = zx.new_empty(K, N, L, H) if state else None
    gates = torch.empty_like(zx) if state else None
    err = _entry("lstm_layer_fwd_f32")(
        zx.data_ptr(), wh.data_ptr(), b.data_ptr(), h.data_ptr(),
        c.data_ptr() if state else None, gates.data_ptr() if state else None,
        K, N, L, H, int(h_all), index,
        torch._C._cuda_getCurrentRawStream(index), None)
    if err != 0:
        raise RuntimeError(f"lstm_layer_fwd launch failed: cudaError {err}")
    lstm_layer_fwd.launches += 1
    return h, c, gates


def lstm_layer_bwd(dH: torch.Tensor, gates: torch.Tensor, c: torch.Tensor,
                   wh: torch.Tensor) -> torch.Tensor:
    """``dZ [K, N, L, 4H]`` of a whole layer (module docstring): the CUDA
    kernel for CUDA tensors, ``lstm_layer_bwd_ref`` for CPU tensors."""
    if not dH.is_cuda:
        return lstm_layer_bwd_ref(dH, gates, c, wh)
    K, N, L, H = _dims("lstm_layer_bwd", gates)
    dh_all = dH.dim() == 4
    index = _check("lstm_layer_bwd", {"dH": dH, "gates": gates, "c": c,
                                      "wh": wh},
                   {"dH": (K, N, L, H) if dh_all else (K, N, H),
                    "gates": (K, N, L, 4 * H), "c": (K, N, L, H),
                    "wh": (K, H, 4 * H)})
    dZ = torch.empty_like(gates)
    err = _entry("lstm_layer_bwd_f32")(
        dH.data_ptr(), gates.data_ptr(), c.data_ptr(), wh.data_ptr(),
        dZ.data_ptr(), K, N, L, H, int(dh_all), index,
        torch._C._cuda_getCurrentRawStream(index), None)
    if err != 0:
        raise RuntimeError(f"lstm_layer_bwd launch failed: cudaError {err}")
    lstm_layer_bwd.launches += 1
    return dZ


lstm_layer_fwd.launches = 0
lstm_layer_bwd.launches = 0


def max_active_clusters(H: int, direction: str = "fwd") -> int:
    """``cudaOccupancyMaxActiveClusters`` of a layer kernel at width ``H``
    on the current card: how many (pair, row block) clusters run at once."""
    index = torch.cuda.current_device()
    out = ctypes.c_int(0)
    name = f"lstm_layer_{direction}_f32"
    ptrs = [None] * (6 if direction == "fwd" else 5)
    err = _entry(name)(*ptrs, 1, LAYER_ROWS, 1, H, 1, index,
                       torch._C._cuda_getCurrentRawStream(index),
                       ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name}: cudaOccupancyMaxActiveClusters failed: "
                           f"cudaError {err}")
    return out.value


class _Layer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, zx, wh, b, sequence):
        wh = wh.contiguous()
        h, c, gates = lstm_layer_fwd(zx.contiguous(), wh, b.contiguous())
        ctx.save_for_backward(h, c, gates, wh)
        return h if sequence else h[:, :, -1].contiguous()

    @staticmethod
    def backward(ctx, dout):
        h, c, gates, wh = ctx.saved_tensors
        dZ = lstm_layer_bwd(dout.contiguous(), gates, c, wh)
        K, N, L, H = h.shape
        dwh = db = None
        if ctx.needs_input_grad[1]:
            prev = torch.zeros_like(h)          # h_{t-1}, h_{-1} = 0
            prev[:, :, 1:] = h[:, :, :-1]
            dwh = torch.bmm(prev.view(K, N * L, H).mT,
                            dZ.view(K, N * L, 4 * H))
        if ctx.needs_input_grad[2]:
            db = dZ.sum((1, 2))
        return dZ, dwh, db, None


def lstm_layer(zx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
               sequence: bool = True) -> torch.Tensor:
    """K pairs' LSTM layers over ``zx [K, N, L, 4H]`` (the input products
    of every step) with ``wh [K, H, 4H]``, ``b [K, 4H]``: every step's
    output ``[K, N, L, H]``, or the last one ``[K, N, H]`` where not
    ``sequence``. Differentiable by autograd (``_Layer``): on the card one
    launch of each layer kernel, forward and backward. The caller checks
    ``layer_refusal`` first."""
    if needs_grad(zx, wh, b):
        return _Layer.apply(zx, wh, b, sequence)
    return lstm_layer_fwd(zx.contiguous(), wh.contiguous(), b.contiguous(),
                          state=False, h_all=sequence)[0]
