"""Functional modules: hyperparameters in the module, parameters outside.

Like flax, a module's ``forward`` takes its parameters as a flat dict keyed
by the flax tree path (``"Dense_0/kernel"``), so a JAX pool converts across
by name (``feddrift_torch.convert``). ``param_specs`` lists every leaf with
its shape and initialiser in a fixed order; that order also defines the
packed ``[..., P]`` layout of ``pack``/``unpack``, the form the training
kernel takes its parameters in.
"""

from __future__ import annotations

import math

import torch
from torch import nn

TRUNC_STD = 0.87962566103423978    # std of N(0, 1) truncated to (-2, 2)

Params = dict[str, torch.Tensor]


def init_leaf(kind: str, shape: tuple[int, ...],
              gen: torch.Generator) -> torch.Tensor:
    """One leaf drawn as flax draws it, on the CPU from ``gen``."""
    if kind == "zeros":
        return torch.zeros(shape)
    if kind == "ones":
        return torch.ones(shape)
    if kind == "lecun_normal":      # flax Dense kernel, fan_in = shape[0]
        std = math.sqrt(1.0 / shape[0]) / TRUNC_STD
        return nn.init.trunc_normal_(torch.empty(shape), 0.0, std,
                                     -2.0 * std, 2.0 * std, generator=gen)
    if kind == "embed":             # flax default_embed_init, fan_in = E
        return torch.randn(shape, generator=gen) * math.sqrt(1.0 / shape[1])
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
