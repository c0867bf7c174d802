"""The linear models of the SEA/SINE/CIRCLE/MNIST runs: the MLP (dense ->
relu -> dense) and the logistic regression (sigmoid over one dense).

Counterparts of ``feddrift_tpu/models/mlp.py::FeedForwardNN`` and
``LogisticRegression`` (flax). Leaf names and layouts are flax's: the
fnn's ``Dense_0/kernel [F, H]``, ``Dense_0/bias [H]``, ``Dense_1/kernel
[H, K]``, ``Dense_1/bias [K]``, the lr's ``Dense_0/kernel [F, K]`` and
``Dense_0/bias [K]``; kernels start as lecun_normal (a normal truncated at
two of its std, scaled by sqrt(1/fan_in)/0.8796), biases at zero. That is
not ``nn.Linear``'s init.
"""

from __future__ import annotations

import math

import torch

from feddrift_torch.models.base import Functional, Params


class FeedForwardNN(Functional):
    """fc1 -> relu -> fc2 over flattened features.

    ``forward(params, x)``: leaves ``[*lead, in, out]`` (biases ``[*lead,
    out]``) and ``x [*lead, N, *feature_shape]`` give logits ``[*lead, N,
    K]``; ``lead`` broadcasts, so one model (no lead), a pool ``[M]``
    against every client's data, or ``[M, C]`` pairs all take one call.
    With per-row leaves ``[B, ...]`` and ``x [B, *feature_shape]`` (no
    sample axis, the pool's ``apply_rows`` form) each row uses its own
    weights.
    """

    def __init__(self, feature_shape: tuple[int, ...], num_classes: int,
                 hidden_dim: int = 10) -> None:
        super().__init__()
        self.feature_shape = tuple(feature_shape)
        self.in_dim = math.prod(self.feature_shape)
        self.num_classes, self.hidden_dim = num_classes, hidden_dim

    def param_specs(self):
        F, H, K = self.in_dim, self.hidden_dim, self.num_classes
        return {"Dense_0/kernel": ((F, H), "lecun_normal"),
                "Dense_0/bias": ((H,), "zeros"),
                "Dense_1/kernel": ((H, K), "lecun_normal"),
                "Dense_1/bias": ((K,), "zeros")}

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w0 = params["Dense_0/kernel"]
        x = x.reshape(*x.shape[:x.ndim - len(self.feature_shape)], self.in_dim)
        rows = x.ndim - 1 == w0.ndim - 2      # per-row weights, no N axis
        if rows:
            x = x.unsqueeze(-2)
        h = torch.relu(x @ w0 + params["Dense_0/bias"].unsqueeze(-2))
        out = h @ params["Dense_1/kernel"] \
            + params["Dense_1/bias"].unsqueeze(-2)
        return out.squeeze(-2) if rows else out


class LogisticRegression(Functional):
    """sigmoid(x W + b) over flattened features. Its outputs are what the
    loss and the eval take as logits (the reference feeds the sigmoid
    outputs to its cross-entropy, and keeps that quirk for parity).

    ``hidden_dim`` is 0: the kernels take a model with no hidden layer as
    the lr (``kernels/local_sgd.py``, ``kernels/eval_cells.py``). Call
    forms as ``FeedForwardNN``'s.
    """

    def __init__(self, feature_shape: tuple[int, ...],
                 num_classes: int) -> None:
        super().__init__()
        self.feature_shape = tuple(feature_shape)
        self.in_dim = math.prod(self.feature_shape)
        self.num_classes, self.hidden_dim = num_classes, 0

    def param_specs(self):
        F, K = self.in_dim, self.num_classes
        return {"Dense_0/kernel": ((F, K), "lecun_normal"),
                "Dense_0/bias": ((K,), "zeros")}

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w = params["Dense_0/kernel"]
        x = x.reshape(*x.shape[:x.ndim - len(self.feature_shape)], self.in_dim)
        rows = x.ndim - 1 == w.ndim - 2      # per-row weights, no N axis
        if rows:
            x = x.unsqueeze(-2)
        out = torch.sigmoid(x @ w + params["Dense_0/bias"].unsqueeze(-2))
        return out.squeeze(-2) if rows else out
