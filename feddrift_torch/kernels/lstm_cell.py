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
the backward kernel. A layer's per-step route (``models/base.py::pair_lstm``
where ``kernels/lstm_layer.py::layer_refusal`` refuses the layer kernels)
checks once a layer (``cell_launcher``) and its L steps then launch
unchecked, with the ctypes entries and the stream looked up once. The
LSTM layers (``models/base.py::pair_lstm``) carry a leading pair axis and
fold it into the cell's rows, so no ``torch.func``
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


def _checked(name: str, tensors: dict, H: int) -> int:
    """``R`` of a call whose tensors are ``[R, H]`` or
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
    return R


class CellLauncher:
    """The cell kernels of one layer's per-step route, checked once: rows
    ``R``, width ``H``, type and device fixed when it is made, its ctypes
    entries and the current stream looked up then. Its calls then only
    launch: they trust the caller to pass contiguous ``[R, 4H]`` / ``[R,
    H]`` tensors of that type on that device (``models/base.py::pair_lstm``
    makes every step's so). The forward writes into the next step of
    ``outs`` (``StepOutputs``) where it is given one, else allocates."""

    __slots__ = ("R", "H", "index", "stream", "_fwd", "_bwd")

    def __init__(self, R: int, H: int, dtype: torch.dtype, device) -> None:
        device = torch.device(device)
        if dtype not in _TYPES or device.type != "cuda" or R < 1 or H < 1:
            raise ValueError(f"lstm_cell: the kernels take R, H >= 1 in "
                             f"float32 or float64 on a CUDA device, got R "
                             f"{R}, H {H}, {dtype} on {device}")
        self.R, self.H = R, H
        self.index = device.index if device.index is not None \
            else torch.cuda.current_device()
        self.stream = torch._C._cuda_getCurrentRawStream(self.index)
        self._fwd = _entry(f"lstm_cell_fwd_{_TYPES[dtype]}")
        self._bwd = _entry(f"lstm_cell_bwd_{_TYPES[dtype]}")

    def fwd(self, z: torch.Tensor, c: torch.Tensor, outs=None):
        """``(h', c', gates)`` of one step: one kernel launch."""
        if outs is None:
            h, cn, gates = torch.empty_like(c), torch.empty_like(c), \
                torch.empty_like(z)
        else:
            h, cn, gates = outs.take()
        err = self._fwd(z.data_ptr(), c.data_ptr(), h.data_ptr(),
                        cn.data_ptr(), gates.data_ptr(), self.R, self.H,
                        self.index, self.stream)
        if err != 0:
            raise RuntimeError(f"lstm_cell_fwd launch failed: cudaError "
                               f"{err}")
        lstm_cell_fwd.launches += 1
        return h, cn, gates

    def bwd(self, dh, dcn, gates, c, cn):
        """``(dz, dc)`` of one step: one kernel launch."""
        dz, dc = torch.empty_like(gates), torch.empty_like(c)
        err = self._bwd(dh.data_ptr(), dcn.data_ptr(), gates.data_ptr(),
                        c.data_ptr(), cn.data_ptr(), dz.data_ptr(),
                        dc.data_ptr(), self.R, self.H, self.index,
                        self.stream)
        if err != 0:
            raise RuntimeError(f"lstm_cell_bwd launch failed: cudaError "
                               f"{err}")
        lstm_cell_bwd.launches += 1
        return dz, dc


class StepOutputs:
    """The forward outputs ``(h' [R, H], c' [R, H], gates [R, 4H])`` of
    ``steps`` steps, allocated at once (three allocations a layer, not
    three a step); ``take`` hands out the next step's, in a ring (call
    ``steps + 1`` writes over the first step's). Held by the caller only:
    an autograd context that kept it would keep its tensors, the outputs'
    own graph, in a reference cycle."""

    __slots__ = ("_slots", "_next")

    def __init__(self, steps: int, R: int, H: int, like: torch.Tensor):
        kw = dict(dtype=like.dtype, device=like.device)
        self._slots = list(zip(torch.empty(steps, R, H, **kw).unbind(0),
                               torch.empty(steps, R, H, **kw).unbind(0),
                               torch.empty(steps, R, 4 * H, **kw).unbind(0)))
        self._next = 0

    def take(self):
        out = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        return out


def cell_launcher(R: int, H: int, like: torch.Tensor) -> CellLauncher | None:
    """The checked-once launcher of a layer's per-step route for ``[R, H]``
    carries of ``like``'s type and device; None on the CPU, where the cell
    takes its plain version."""
    return CellLauncher(R, H, like.dtype, like.device) if like.is_cuda \
        else None


def lstm_cell_fwd(z: torch.Tensor, c: torch.Tensor):
    """``(h' [R, H], c' [R, H], gates [R, 4H])`` of one cell step: the
    CUDA kernel for CUDA tensors, ``lstm_cell_fwd_ref`` for CPU tensors.
    Every call is checked (``CellLauncher`` checks once a layer)."""
    if not z.is_cuda:
        return lstm_cell_fwd_ref(z, c)
    H = c.shape[-1]
    R = _checked("lstm_cell_fwd", {"z": z, "c": c}, H)
    return CellLauncher(R, H, z.dtype, z.device).fwd(z, c)


def lstm_cell_bwd(dh, dcn, gates, c, cn):
    """``(dz [R, 4H], dc [R, H])`` of one cell step: the CUDA kernel for
    CUDA tensors, ``lstm_cell_bwd_ref`` for CPU tensors. Every call is
    checked."""
    if not dh.is_cuda:
        return lstm_cell_bwd_ref(dh, dcn, gates, c, cn)
    H = c.shape[-1]
    R = _checked("lstm_cell_bwd", {"dh": dh, "dcn": dcn, "gates": gates,
                                   "c": c, "cn": cn}, H)
    return CellLauncher(R, H, dh.dtype, dh.device).bwd(dh, dcn, gates, c, cn)


lstm_cell_fwd.launches = 0
lstm_cell_bwd.launches = 0


class _Cell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, c, launcher, outs):
        if launcher is None:
            h, cn, gates = lstm_cell_fwd(z.contiguous(), c.contiguous())
        else:
            h, cn, gates = launcher.fwd(z, c, outs)
        ctx.launcher = launcher
        ctx.save_for_backward(gates, c, cn)
        return h, cn

    @staticmethod
    def backward(ctx, dh, dcn):
        gates, c, cn = ctx.saved_tensors
        dh, dcn = dh.contiguous(), dcn.contiguous()
        if ctx.launcher is None:
            return (*lstm_cell_bwd(dh, dcn, gates, c.contiguous(), cn), None,
                    None)
        return (*ctx.launcher.bwd(dh, dcn, gates, c, cn), None, None)


def lstm_cell(z: torch.Tensor, c: torch.Tensor,
              launcher: CellLauncher | None = None,
              outs: StepOutputs | None = None):
    """``(h', c')`` of one cell step on ``z [R, 4H]`` and ``c [R, H]``,
    differentiable by autograd (``_Cell``): forward and backward each one
    launch of their kernel on the card. With a ``launcher`` (the per-step
    route's, ``cell_launcher``) the calls skip the per-call checks, and
    with ``outs`` the forward writes into the next of a layer's
    preallocated steps."""
    return _Cell.apply(z, c, launcher, outs)
