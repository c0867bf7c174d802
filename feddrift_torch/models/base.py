"""Functional modules: hyperparameters in the module, parameters outside.

Like flax, a module's ``forward`` takes its parameters as a flat dict keyed
by the flax tree path (``"Dense_0/kernel"``), so a JAX pool converts across
by name (``feddrift_torch.convert``). ``param_specs`` lists every leaf with
its shape and initialiser in a fixed order; that order also defines the
packed ``[..., P]`` layout of ``pack``/``unpack``, the form the training
kernel takes its parameters in.

The conv models' layers (``conv``, ``max_pool``, ``batch_norm``,
``group_norm``, ``dense``) keep flax's leaf layouts (conv kernels HWIO
``[kh, kw, in, out]``) and XLA's arithmetic: "SAME" padding is XLA's, which
puts the odd pixel after (a 3x3 conv at stride 2 on an even side pads 0
before and 1 after, where ``torch.nn.Conv2d(padding=1)`` pads 1 on both
sides), the batch norm's variance is the population variance, and
GroupNorm's is flax's ``E[x^2] - E[x]^2`` with eps 1e-6. Activations run
NCHW between the layers, the layout ``torch.nn.functional.conv2d`` takes;
a model turns its NHWC input once on entry and back before a flatten,
which flax takes in H, W, C order.

The LSTMs' layers (``pair_embed``, ``pair_lstm``, ``pair_dense``) keep
flax's leaves too: an
``nn.Embed``'s ``embedding [V, E]``, and the input kernels
``i{i,f,g,o}/kernel [in, H]`` (no bias) and recurrent kernels and biases
``h{i,f,g,o}/kernel [H, H]``, ``/bias [H]`` of the ``OptimizedLSTMCell``
that an ``nn.RNN`` scans (flax names the cell in its parent's scope:
``OptimizedLSTMCell_0``), each four concatenated along the output axis
before one product.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import vmap

from feddrift_torch.kernels.lstm_cell import lstm_cell

TRUNC_STD = 0.87962566103423978    # std of N(0, 1) truncated to (-2, 2)

Params = dict[str, torch.Tensor]


def init_leaf(kind: str, shape: tuple[int, ...],
              gen: torch.Generator) -> torch.Tensor:
    """One leaf drawn as flax draws it, on the CPU from ``gen``."""
    if kind == "zeros":
        return torch.zeros(shape)
    if kind == "ones":
        return torch.ones(shape)
    if kind == "lecun_normal":      # flax Dense / Conv kernel: [..., in, out]
        std = math.sqrt(1.0 / math.prod(shape[:-1])) / TRUNC_STD
        return nn.init.trunc_normal_(torch.empty(shape), 0.0, std,
                                     -2.0 * std, 2.0 * std, generator=gen)
    if kind == "embed":             # flax default_embed_init, fan_in = E
        return torch.randn(shape, generator=gen) * math.sqrt(1.0 / shape[1])
    if kind == "orthogonal":        # flax initializers.orthogonal(), scale 1
        rows, cols = math.prod(shape[:-1]), shape[-1]
        a = torch.randn((cols, rows) if rows < cols else (rows, cols),
                        generator=gen)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        return (q.T if rows < cols else q).reshape(shape)
    raise ValueError(kind)


class Functional(nn.Module):
    """A module whose parameters live outside it, in a flat dict."""

    def param_specs(self) -> dict[str, tuple[tuple[int, ...], str]]:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator,
                    device: str | torch.device = "cuda") -> Params:
        """One model's parameters (no row axis), flax's distributions,
        drawn on the CPU from ``generator`` and moved to ``device``."""
        return {name: init_leaf(kind, shape, generator).to(device)
                for name, (shape, kind) in self.param_specs().items()}

    @property
    def num_params(self) -> int:
        return sum(math.prod(shape) for shape, _ in self.param_specs().values())

    def pack(self, params: Params) -> torch.Tensor:
        """Leaves ``[*lead, *shape]`` -> one ``[*lead, P]`` tensor, leaves
        concatenated in ``param_specs`` order."""
        specs = self.param_specs()
        first, (shape0, _) = next(iter(specs)), next(iter(specs.values()))
        lead = params[first].shape[:params[first].ndim - len(shape0)]
        return torch.cat([params[k].reshape(*lead, -1) for k in specs], -1)

    def unpack(self, flat: torch.Tensor) -> Params:
        """The inverse of ``pack``: views of ``flat [*lead, P]``."""
        out, off = {}, 0
        for name, (shape, _) in self.param_specs().items():
            n = math.prod(shape)
            out[name] = flat[..., off:off + n].unflatten(-1, shape)
            off += n
        return out

    def apply_one(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """One model's leaves (no row axis) on a batch ``x [B, ...]``: the
        leaves broadcast over the rows, which the forward takes per row."""
        B = x.shape[0]
        return self({k: p[None].expand(B, *p.shape)
                     for k, p in params.items()}, x)

    def apply_rows(self, rows: Params, x: torch.Tensor) -> torch.Tensor:
        """Per-row leaves ``[B, ...]`` on ``x [B, ...]``."""
        return self(rows, x)


class GenericNet(Functional):
    """A model trained by the model-generic local SGD
    (``core/functional.py::model_local_sgd``) rather than K1, and evaluated
    through its forward (``model_logits``) rather than K3: the conv models
    and the LSTMs.

    ``forward(params, x)``: one model's leaves (no row axis) and ``x [N,
    *feature_shape]`` give logits ``[N, K]``; a batch norm's statistics are
    those of the N rows. The pool's and the pairs' axes go through
    ``torch.func.vmap``, unless the model defines ``pair_logits(leaves [P,
    ...], x [P, N, *feature_shape]) -> [P, N, K]``: P models at once, each
    on its own rows, every row independent of the others. Then
    ``model_local_sgd`` takes the pairs' gradients by plain autograd
    through that one batched program, and ``model_logits`` runs a model's
    groups of rows as one batch: the host dispatches each op once for all
    pairs, where a ``vmap`` of ``grad`` passes every op through
    ``torch.func``'s layers (the LSTMs: thousands of small ops a step)."""

    feature_shape: tuple[int, ...]
    num_classes: int
    pair_logits = None

    def apply_one(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """One model's leaves on a batch ``x [B, ...]``: one forward."""
        return self(params, x)

    def apply_rows(self, rows: Params, x: torch.Tensor) -> torch.Tensor:
        """Per-row leaves ``[B, ...]`` on ``x [B, ...]``: each row a batch
        of one, as the JAX package's ``ForwardStep`` applies a row (a
        ``vmap``, or ``pair_logits`` with B pairs of one row)."""
        if self.pair_logits is not None:
            return self.pair_logits(rows, x[:, None])[:, 0]
        return vmap(lambda p, xr: self(p, xr[None])[0])(rows, x)


class ConvNet(GenericNet):
    """A model of convolutions, pools, norms and Dense layers (the cnns and
    the ResNets)."""


@contextlib.contextmanager
def model_numerics():
    """The model-generic path's numerics on the card, for the scope of one
    program and restored after it: float32 convolutions and matmuls (the
    LSTMs' gate products) without TF32 (cuDNN takes TF32 by default), and
    deterministic cuDNN algorithms without autotuning, so a round gives the
    same bits call after call. ``core/functional.py``'s programs
    (``model_local_sgd``, ``model_logits``) run inside it, their backward
    included."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    held = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
            matmul.allow_tf32)
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = False, True, False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
         matmul.allow_tf32) = held


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial side: ceil(size / stride)
    outputs, the odd pixel of padding after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, params: Params, name: str, stride: int = 1,
         padding: str = "SAME") -> torch.Tensor:
    """flax ``nn.Conv`` on NCHW ``x``: kernel ``{name}/kernel [kh, kw, in,
    out]``, bias ``{name}/bias`` where the layer has one."""
    w = params[f"{name}/kernel"]
    kh, kw = w.shape[:2]
    pad = (0, 0)
    if padding == "SAME":
        (h0, h1), (w0, w1) = (_same_pads(x.shape[-2], kh, stride),
                              _same_pads(x.shape[-1], kw, stride))
        if (h0, w0) == (h1, w1):
            pad = (h0, w0)
        else:
            x = F.pad(x, (w0, w1, h0, h1))
    return F.conv2d(x, w.permute(3, 2, 0, 1), params.get(f"{name}/bias"),
                    stride=stride, padding=pad)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool(x, (2, 2), strides=(2, 2))`` (VALID)."""
    return F.max_pool2d(x, 2, 2)


def dense(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    """flax ``nn.Dense``: ``x @ kernel + bias``."""
    return x @ params[f"{name}/kernel"] + params[f"{name}/bias"]


def batch_norm(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    """The ResNets' stateless per-batch norm of NCHW ``x`` over (N, H, W),
    population variance, eps 1e-5 (``feddrift_tpu/models/resnet.py::_Norm``,
    its float32 branch)."""
    mean = x.mean((0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean((0, 2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) \
        * params[f"{name}/scale"][:, None, None] \
        + params[f"{name}/bias"][:, None, None]


def group_norm(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    """flax ``nn.GroupNorm(num_groups=min(32, C))`` of NCHW ``x``: each
    row's group statistics over (C / G, H, W), the variance ``E[x^2] -
    E[x]^2`` clipped at 0, eps 1e-6."""
    N, C, H, W = x.shape
    G = min(32, C)
    xg = x.reshape(N, G, C // G, H, W)
    mean = xg.mean((2, 3, 4), keepdim=True)
    var = torch.clamp((xg * xg).mean((2, 3, 4), keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + 1e-6).expand(N, G, C // G, 1, 1).reshape(
        N, C, 1, 1) * params[f"{name}/scale"][:, None, None]
    mean = mean.expand(N, G, C // G, 1, 1).reshape(N, C, 1, 1)
    return (x - mean) * mul + params[f"{name}/bias"][:, None, None]


def pair_embed(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    """flax ``nn.Embed`` of each of K pairs: ``x [K, ...]`` token ids (which
    may arrive as float, after a feature mask: exact below 2^24) through
    the pair's own table ``{name}/embedding [K, V, E]``; one embedding
    lookup in the K tables stacked, each pair's ids offset by k·V."""
    table = params[f"{name}/embedding"]
    K, V = table.shape[:2]
    offset = torch.arange(K, device=x.device).view(K, *(1,) * (x.dim() - 1))
    return F.embedding(x.long() + offset * V, table.reshape(K * V, -1))


def pair_dense(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    """flax ``nn.Dense`` of each of K pairs: ``x [K, N, in]`` -> ``[K, N,
    out]``, ``bias + x @ kernel``."""
    return torch.baddbmm(params[f"{name}/bias"][:, None], x,
                         params[f"{name}/kernel"])


LSTM_GATES = "ifgo"     # flax's OptimizedLSTMCell concatenation order


def pair_lstm(x: torch.Tensor, params: Params, name: str,
              sequence: bool = True) -> torch.Tensor:
    """flax ``nn.RNN(nn.OptimizedLSTMCell(H))`` of each of K pairs (the
    cell's scope ``name``, e.g. ``OptimizedLSTMCell_0``; leaves ``[K,
    ...]``) over ``x [K, N, L, in]`` from a zero carry: every step's output
    ``[K, N, L, H]``, or the last one ``[K, N, H]`` where not
    ``sequence``. The input products of all L steps are one batched
    product; a step's pre-activations are flax's ``(h·W_h + b) + x·W_i``,
    and its cell, over the K·N rows, ``kernels/lstm_cell.py::lstm_cell``
    (one kernel launch forward, one backward, on the card)."""
    K, N, L = x.shape[:3]
    wi = torch.cat([params[f"{name}/i{g}/kernel"] for g in LSTM_GATES], -1)
    wh = torch.cat([params[f"{name}/h{g}/kernel"] for g in LSTM_GATES], -1)
    b = torch.cat([params[f"{name}/h{g}/bias"] for g in LSTM_GATES], -1)
    H = wh.shape[1]
    zx = torch.bmm(x.reshape(K, N * L, -1), wi).view(K, N, L, 4 * H)
    h = x.new_zeros(K, N, H)
    c = x.new_zeros(K * N, H)
    outs = []
    # unbind, not zx[:, :, t]: a slice's backward would write a zero tensor
    # of zx's whole size a step, where unbind's stacks the L gradients once
    for zt in zx.unbind(2):
        z = torch.baddbmm(b[:, None], h, wh) + zt
        h, c = lstm_cell(z.view(K * N, 4 * H), c)
        h = h.view(K, N, H)
        outs.append(h)
    return torch.stack(outs, 2) if sequence else h


def lstm_specs(name: str, features: int,
               hidden: int) -> dict[str, tuple[tuple[int, ...], str]]:
    """``param_specs`` of one ``pair_lstm`` scope, flax's initialisers: input
    kernels lecun_normal, recurrent kernels orthogonal, biases zeros."""
    specs = {}
    for g in LSTM_GATES:
        specs[f"{name}/i{g}/kernel"] = ((features, hidden), "lecun_normal")
        specs[f"{name}/h{g}/kernel"] = ((hidden, hidden), "orthogonal")
        specs[f"{name}/h{g}/bias"] = ((hidden,), "zeros")
    return specs
