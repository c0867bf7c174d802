"""The CIFAR ResNets (6n+2: ``resnet8``, ``resnet20``, ``resnet56``,
``resnet110``, and ``resnet56_gn`` with GroupNorm) and ``resnet18``.

Counterparts of ``feddrift_tpu/models/resnet.py`` (flax) on its float32
branch. Leaf names follow the flax tree paths, e.g.
``ResNetFeatures_0/BasicBlock_0/Conv_0/kernel [3, 3, 16, 16]`` and
``ResNetServerTail_0/BasicBlock_0/_Norm_2/scale``; a GroupNorm's leaves sit
one scope lower (``.../_Norm_0/GroupNorm_0/scale``). Convs have no bias;
norm scales start at one, biases at zero.

The norm is the JAX package's ``_Norm``: "batch" is its stateless
per-batch norm over (N, H, W) (no running statistics: each call normalises
by the statistics of the rows it is given), "group" flax's ``GroupNorm``
with min(32, C) groups. Its half-width branch (bfloat16 activations) is not
ported (ROADMAP §1 'Precision').

A 6n+2 ResNet is the JAX package's ``ResNetFeatures`` (the 16-filter stem
and stage) then ``ResNetServerTail`` (the 32- and 64-filter stages, the
mean pool and ``Dense_0``); ``ResNet18`` is a 64-filter 3x3 stem and four
stages of two blocks (64, 128, 256, 512), the mean pool and ``Dense_0``.
A block's shortcut is a 1x1 conv and norm where the block changes the
shape (stride 2 or more filters), as flax's ``residual.shape !=
y.shape``. Strided convs pad as XLA's "SAME" does (``models/base.py``).
"""

from __future__ import annotations

import torch

from feddrift_torch.models.base import (ConvNet, Params, batch_norm, conv,
                                        dense, group_norm)

NORMS = ("batch", "group")


class _ResNet(ConvNet):
    """Stem conv + norm, ``blocks`` of ``(scope, in, filters, stride)``,
    the mean pool and ``{head}/Dense_0``."""

    stem = head = ""
    stem_filters = 16

    def __init__(self, feature_shape: tuple[int, ...], num_classes: int,
                 norm: str) -> None:
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm {norm!r}: one of {NORMS}")
        self.feature_shape = tuple(feature_shape)
        self.num_classes, self.norm = num_classes, norm
        # a flat row is a 32 x 32 x 3 image (ResNetFeatures' reshape)
        self.image = (32, 32, 3) if len(feature_shape) == 1 \
            else tuple(feature_shape)
        self.blocks = self._blocks()

    def _blocks(self) -> list[tuple[str, int, int, int]]:
        raise NotImplementedError

    def _norm_specs(self, scope: str, channels: int) -> dict:
        if self.norm == "group":
            scope += "/GroupNorm_0"
        return {f"{scope}/scale": ((channels,), "ones"),
                f"{scope}/bias": ((channels,), "zeros")}

    def _norm(self, x: torch.Tensor, params: Params, scope: str):
        if self.norm == "group":
            return group_norm(x, params, scope + "/GroupNorm_0")
        return batch_norm(x, params, scope)

    def param_specs(self):
        cin, f0 = self.image[2], self.stem_filters
        specs = {f"{self.stem}Conv_0/kernel": ((3, 3, cin, f0),
                                               "lecun_normal")}
        specs.update(self._norm_specs(f"{self.stem}_Norm_0", f0))
        for scope, cin, f, stride in self.blocks:
            specs[f"{scope}/Conv_0/kernel"] = ((3, 3, cin, f), "lecun_normal")
            specs.update(self._norm_specs(f"{scope}/_Norm_0", f))
            specs[f"{scope}/Conv_1/kernel"] = ((3, 3, f, f), "lecun_normal")
            specs.update(self._norm_specs(f"{scope}/_Norm_1", f))
            if stride != 1 or cin != f:
                specs[f"{scope}/Conv_2/kernel"] = ((1, 1, cin, f),
                                                   "lecun_normal")
                specs.update(self._norm_specs(f"{scope}/_Norm_2", f))
        last = self.blocks[-1][2] if self.blocks else f0
        specs[f"{self.head}Dense_0/kernel"] = ((last, self.num_classes),
                                               "lecun_normal")
        specs[f"{self.head}Dense_0/bias"] = ((self.num_classes,), "zeros")
        return specs

    def _block(self, x, params, scope: str, cin: int, f: int, stride: int):
        y = conv(x, params, f"{scope}/Conv_0", stride)
        y = torch.relu(self._norm(y, params, f"{scope}/_Norm_0"))
        y = self._norm(conv(y, params, f"{scope}/Conv_1"), params,
                       f"{scope}/_Norm_1")
        if stride != 1 or cin != f:
            x = self._norm(conv(x, params, f"{scope}/Conv_2", stride), params,
                           f"{scope}/_Norm_2")
        return torch.relu(y + x)

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], *self.image).permute(0, 3, 1, 2)
        x = torch.relu(self._norm(conv(x, params, f"{self.stem}Conv_0"),
                                  params, f"{self.stem}_Norm_0"))
        for block in self.blocks:
            x = self._block(x, params, *block)
        return dense(x.mean((2, 3)), params, f"{self.head}Dense_0")


class ResNetCifar(_ResNet):
    """6n+2 CIFAR ResNet: n blocks of 16 filters (``ResNetFeatures_0``),
    then n of 32 and n of 64, each stage's first at stride 2
    (``ResNetServerTail_0``)."""

    stem, head = "ResNetFeatures_0/", "ResNetServerTail_0/"

    def __init__(self, feature_shape: tuple[int, ...], num_classes: int = 10,
                 depth: int = 20, norm: str = "batch") -> None:
        self.depth = depth
        super().__init__(feature_shape, num_classes, norm)

    def _blocks(self):
        n = (self.depth - 2) // 6
        blocks = [(f"ResNetFeatures_0/BasicBlock_{i}", 16, 16, 1)
                  for i in range(n)]
        cin, i = 16, 0
        for f in (32, 64):
            for b in range(n):
                blocks.append((f"ResNetServerTail_0/BasicBlock_{i}", cin, f,
                               2 if b == 0 else 1))
                cin, i = f, i + 1
        return blocks


class ResNet18(_ResNet):
    """ResNet-18 (torchvision's 2-2-2-2 blocks) with a 3x3 CIFAR stem."""

    stem_filters = 64

    def __init__(self, feature_shape: tuple[int, ...], num_classes: int = 10,
                 norm: str = "batch") -> None:
        super().__init__(feature_shape, num_classes, norm)

    def _blocks(self):
        blocks, cin = [], 64
        for stage, f in enumerate((64, 128, 256, 512)):
            for b in range(2):
                blocks.append((f"BasicBlock_{2 * stage + b}", cin, f,
                               2 if stage > 0 and b == 0 else 1))
                cin = f
        return blocks
