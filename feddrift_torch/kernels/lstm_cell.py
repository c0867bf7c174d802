"""The pointwise part of one LSTM time step (the cell): the CUDA kernels'
wrappers, their plain versions, and ``lstm_cell``, the differentiable op
the LSTM layer calls.

The JAX package has no Pallas kernel here: flax's ``OptimizedLSTMCell``
(``feddrift_tpu/models/rnn.py``) leaves the gate activations and the state
update to XLA. The kernels are in ``csrc/lstm_cell.cu``, whose source
notes what bounds them and their design.

- ``lstm_cell_fwd(z [R, 4H], c [R, H]) -> (h' [R, H], c' [R, H], gates
  [R, 4H])``: the gate pre-activations (order i, f, g, o) and the carry
  give the new hidden state and carry, and the activated gates that the
  backward reads.
- ``lstm_cell_bwd(dh', dc', gates, c, c') -> (dz [R, 4H], dc [R, H])``.

Each wrapper launches its kernel (float32 or float64) for CUDA tensors and
takes its plain version (``lstm_cell_fwd_ref``, ``lstm_cell_bwd_ref``) for
CPU tensors. There is no fallback for a CUDA tensor: the kernel launches or
the call raises. ``lstm_cell_fwd.launches`` and ``lstm_cell_bwd.launches``
count launches; the plain versions' ``cuda_calls`` count their calls on
CUDA tensors (only a comparison with the kernels makes them).

``lstm_cell`` joins the two in an ``autograd.Function`` whose backward is
the backward kernel. The LSTM layers (``models/base.py::pair_lstm``) carry
a leading pair axis and fold it into the cell's rows, so no ``torch.func``
transform reaches the cell: a ctypes launch needs a tensor's
``data_ptr``, which a batched tensor of ``vmap`` does not have.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from feddrift_torch.kernels.build import library

_TYPES = {torch.float32: "f32", torch.float64: "f64"}


def lstm_cell_fwd_ref(z: torch.Tensor, c: torch.Tensor):
    """The plain forward: ``(h', c', gates)``, the kernel's steps in its
    order."""
    if z.is_cuda:
        lstm_cell_fwd_ref.cuda_calls += 1
    zi, zf, zg, zo = z.split(c.shape[-1], -1)
    i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
    g = torch.tanh(zg)
    cn = f * c + i * g
    return o * torch.tanh(cn), cn, torch.cat([i, f, g, o], -1)


def lstm_cell_bwd_ref(dh, dcn, gates, c, cn):
    """The plain backward: ``(dz, dc)``, the kernel's steps in its order."""
    if dh.is_cuda:
        lstm_cell_bwd_ref.cuda_calls += 1
    i, f, g, o = gates.split(c.shape[-1], -1)
    t = torch.tanh(cn)
    dct = dcn + dh * o * (1 - t * t)
    dz = torch.cat([dct * g * i * (1 - i), dct * c * f * (1 - f),
                    dct * i * (1 - g * g), dh * t * o * (1 - o)], -1)
    return dz, dct * f


lstm_cell_fwd_ref.cuda_calls = 0
lstm_cell_bwd_ref.cuda_calls = 0


@functools.cache
def _entry(name: str):
    """A C entry point of ``csrc/lstm_cell.cu``, its signature set once."""
    fn = getattr(library("lstm_cell"), name)
    fn.restype = ctypes.c_int
    pointers = 5 if name.startswith("lstm_cell_fwd") else 7
    fn.argtypes = [ctypes.c_void_p] * pointers \
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def _checked(name: str, tensors: dict, H: int) -> tuple[int, int]:
    """``(R, device index)`` of a call whose tensors are ``[R, H]`` or
    ``[R, 4H]`` (``gates``, ``z``, ``dz``); raises on a shape, type,
    device or layout the kernel does not take."""
    first = next(iter(tensors.values()))
    R, index = first.shape[0], first.get_device()
    for key, t in tensors.items():
        width = 4 * H if key in ("z", "gates") else H
        if t.dim() != 2 or tuple(t.shape) != (R, width):
            raise ValueError(f"{name}: {key} must be [{R}, {width}], got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _TYPES or t.dtype != first.dtype or not t.is_cuda \
                or t.get_device() != index or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be a contiguous "
                             f"float32 or float64 tensor on cuda:{index}, "
                             f"{key} is {t.dtype} on {t.device}")
    if not (R and H):
        raise ValueError(f"{name} takes R, H >= 1, got ({R}, {H})")
    return R, index


def _launch(name: str, ins: tuple, outs: tuple, R: int, H: int,
            index: int) -> None:
    err = _entry(f"{name}_{_TYPES[ins[0].dtype]}")(
        *(t.data_ptr() for t in ins + outs), R, H, index,
        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def lstm_cell_fwd(z: torch.Tensor, c: torch.Tensor):
    """``(h' [R, H], c' [R, H], gates [R, 4H])`` of one cell step: the
    CUDA kernel for CUDA tensors, ``lstm_cell_fwd_ref`` for CPU tensors."""
    if not z.is_cuda:
        return lstm_cell_fwd_ref(z, c)
    H = c.shape[-1]
    R, index = _checked("lstm_cell_fwd", {"z": z, "c": c}, H)
    h, cn = torch.empty_like(c), torch.empty_like(c)
    gates = torch.empty_like(z)
    _launch("lstm_cell_fwd", (z, c), (h, cn, gates), R, H, index)
    lstm_cell_fwd.launches += 1
    return h, cn, gates


def lstm_cell_bwd(dh, dcn, gates, c, cn):
    """``(dz [R, 4H], dc [R, H])`` of one cell step: the CUDA kernel for
    CUDA tensors, ``lstm_cell_bwd_ref`` for CPU tensors."""
    if not dh.is_cuda:
        return lstm_cell_bwd_ref(dh, dcn, gates, c, cn)
    H = c.shape[-1]
    R, index = _checked("lstm_cell_bwd", {"dh": dh, "dcn": dcn,
                                          "gates": gates, "c": c, "cn": cn},
                        H)
    dz, dc = torch.empty_like(gates), torch.empty_like(c)
    _launch("lstm_cell_bwd", (dh, dcn, gates, c, cn), (dz, dc), R, H, index)
    lstm_cell_bwd.launches += 1
    return dz, dc


lstm_cell_fwd.launches = 0
lstm_cell_bwd.launches = 0


class _Cell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, c):
        h, cn, gates = lstm_cell_fwd(z.contiguous(), c.contiguous())
        ctx.save_for_backward(gates, c, cn)
        return h, cn

    @staticmethod
    def backward(ctx, dh, dcn):
        gates, c, cn = ctx.saved_tensors
        return lstm_cell_bwd(dh.contiguous(), dcn.contiguous(), gates,
                             c.contiguous(), cn)


def lstm_cell(z: torch.Tensor, c: torch.Tensor):
    """``(h', c')`` of one cell step on ``z [R, 4H]`` and ``c [R, H]``,
    differentiable by autograd (``_Cell``): forward and backward each one
    launch of their kernel on the card."""
    return _Cell.apply(z, c)
