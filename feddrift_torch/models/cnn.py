"""The FedAvg CNNs: ``CNNFedAvg`` (``cnn``) and ``CNNDropout``
(``cnn_dropout``).

Counterparts of ``feddrift_tpu/models/cnn.py`` (flax). Leaf names and
layouts are flax's (``Conv_0/kernel [kh, kw, in, out]``, ``Dense_0/kernel
[in, out]``); kernels start as lecun_normal with fan_in = kh·kw·in for a
conv, biases at zero. Both return logits.

``CNNDropout``'s two dropouts never drop: the JAX package applies every
model without an rng (``feddrift_tpu/simulation/runner.py``'s ``apply_fn``,
``module.apply({"params": p}, x)``), so its dropouts run deterministic in
training and eval alike, and so do the port's, which leave them out.
"""

from __future__ import annotations

import torch

from feddrift_torch.models.base import ConvNet, Params, conv, dense, max_pool


def _image_shape(feature_shape: tuple[int, ...], side: int = 28,
                 channels: int = 1) -> tuple[int, int, int]:
    """The NHWC image a row of ``feature_shape`` becomes (``_to_nhwc``):
    a flat row ``side x side x channels``, ``(H, W)`` one channel."""
    if len(feature_shape) == 1:
        return side, side, channels
    if len(feature_shape) == 2:
        return (*feature_shape, 1)
    return tuple(feature_shape)


def _to_nchw(x: torch.Tensor, image: tuple[int, int, int]) -> torch.Tensor:
    """``x [N, *feature_shape]`` as the NCHW view of its NHWC image."""
    return x.reshape(x.shape[0], *image).permute(0, 3, 1, 2)


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> ``[N, H·W·C]`` in flax's (NHWC) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class CNNFedAvg(ConvNet):
    """conv5x5(32) -> pool -> conv5x5(64) -> pool -> fc512 -> relu -> fc K,
    no activation after the convs (as the JAX package's); 1,690,046 params
    at femnist's 28 x 28 x 1 and 62 classes, 2,183,166 at fmow's 32 x 32 x
    3."""

    def __init__(self, feature_shape: tuple[int, ...],
                 num_classes: int = 10) -> None:
        super().__init__()
        self.feature_shape = tuple(feature_shape)
        self.num_classes = num_classes
        self.image = _image_shape(self.feature_shape)

    def param_specs(self):
        H, W, Ci = self.image
        flat = (H // 2 // 2) * (W // 2 // 2) * 64
        return {"Conv_0/kernel": ((5, 5, Ci, 32), "lecun_normal"),
                "Conv_0/bias": ((32,), "zeros"),
                "Conv_1/kernel": ((5, 5, 32, 64), "lecun_normal"),
                "Conv_1/bias": ((64,), "zeros"),
                "Dense_0/kernel": ((flat, 512), "lecun_normal"),
                "Dense_0/bias": ((512,), "zeros"),
                "Dense_1/kernel": ((512, self.num_classes), "lecun_normal"),
                "Dense_1/bias": ((self.num_classes,), "zeros")}

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(conv(_to_nchw(x, self.image), params, "Conv_0"))
        x = max_pool(conv(x, params, "Conv_1"))
        x = torch.relu(dense(_flatten(x), params, "Dense_0"))
        return dense(x, params, "Dense_1")


class CNNDropout(ConvNet):
    """conv3x3(32) -> relu -> conv3x3(64) -> relu -> pool -> fc128 -> relu
    -> fc K, both convs VALID (the dropouts never drop: see the module's
    note); 1,206,590 params at femnist's width."""

    def __init__(self, feature_shape: tuple[int, ...],
                 num_classes: int = 62) -> None:
        super().__init__()
        self.feature_shape = tuple(feature_shape)
        self.num_classes = num_classes
        self.image = _image_shape(self.feature_shape)

    def param_specs(self):
        H, W, Ci = self.image
        flat = ((H - 4) // 2) * ((W - 4) // 2) * 64
        return {"Conv_0/kernel": ((3, 3, Ci, 32), "lecun_normal"),
                "Conv_0/bias": ((32,), "zeros"),
                "Conv_1/kernel": ((3, 3, 32, 64), "lecun_normal"),
                "Conv_1/bias": ((64,), "zeros"),
                "Dense_0/kernel": ((flat, 128), "lecun_normal"),
                "Dense_0/bias": ((128,), "zeros"),
                "Dense_1/kernel": ((128, self.num_classes), "lecun_normal"),
                "Dense_1/bias": ((self.num_classes,), "zeros")}

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(conv(_to_nchw(x, self.image), params, "Conv_0",
                            padding="VALID"))
        x = max_pool(torch.relu(conv(x, params, "Conv_1", padding="VALID")))
        x = torch.relu(dense(_flatten(x), params, "Dense_0"))
        return dense(x, params, "Dense_1")
