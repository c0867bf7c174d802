"""Model registry of the port: ``create_model(name, ds, cfg)``.

Mirrors ``feddrift_tpu/models/__init__.py``, with the registry's exact
sizes: the ``lr``, the ``fnn``, the conv models (``cnn``, ``cnn_dropout``,
``resnet`` / ``resnet20``, ``resnet8``, ``resnet56``, ``resnet110``,
``resnet56_gn``, ``resnet18``) and the served ``transformer``. The JAX
package's other names (``UNPORTED``) raise ``NotImplementedError`` naming
the ROADMAP item that queues them; a name neither package knows raises
``KeyError``.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from feddrift_torch.data.drift_dataset import DriftDataset

_BUILDERS: dict[str, Callable[..., nn.Module]] = {}


def register_model(*names: str):
    def deco(fn):
        for n in names:
            _BUILDERS[n] = fn
        return fn
    return deco


def available_models() -> list[str]:
    return sorted(_BUILDERS)


@register_model("lr")
def _lr(ds: DriftDataset, cfg) -> nn.Module:
    from feddrift_torch.models.mlp import LogisticRegression
    return LogisticRegression(ds.feature_shape, num_classes=ds.num_classes)


@register_model("fnn")
def _fnn(ds: DriftDataset, cfg) -> nn.Module:
    from feddrift_torch.models.mlp import FeedForwardNN
    return FeedForwardNN(ds.feature_shape, num_classes=ds.num_classes,
                         hidden_dim=getattr(cfg, "fnn_hidden_dim", 10))


@register_model("cnn")
def _cnn(ds: DriftDataset, cfg) -> nn.Module:
    from feddrift_torch.models.cnn import CNNFedAvg
    return CNNFedAvg(ds.feature_shape, num_classes=ds.num_classes)


@register_model("cnn_dropout")
def _cnnd(ds: DriftDataset, cfg) -> nn.Module:
    from feddrift_torch.models.cnn import CNNDropout
    return CNNDropout(ds.feature_shape, num_classes=ds.num_classes)


def _resnet_cifar(depth: int, norm: str = "batch"):
    def build(ds: DriftDataset, cfg) -> nn.Module:
        from feddrift_torch.models.resnet import ResNetCifar
        return ResNetCifar(ds.feature_shape, num_classes=ds.num_classes,
                           depth=depth, norm=norm)
    return build


register_model("resnet", "resnet20")(_resnet_cifar(20))
register_model("resnet8")(_resnet_cifar(8))
register_model("resnet56")(_resnet_cifar(56))
register_model("resnet110")(_resnet_cifar(110))
register_model("resnet56_gn")(_resnet_cifar(56, "group"))


@register_model("resnet18")
def _resnet18(ds: DriftDataset, cfg) -> nn.Module:
    from feddrift_torch.models.resnet import ResNet18
    return ResNet18(ds.feature_shape, num_classes=ds.num_classes)


@register_model("transformer")
def _transformer(ds: DriftDataset, cfg) -> nn.Module:
    from feddrift_torch.models.transformer import TransformerLM
    return TransformerLM(vocab_size=ds.num_classes,
                         max_len=max(ds.feature_shape[0]
                                     if ds.is_sequence else 128, 128))


# the JAX package's models the port does not build yet
UNPORTED = ("mobilenet", "mobilenet_gn", "densenet", "densenet121", "darts",
            "rnn", "rnn_stackoverflow")


def create_model(name: str, ds: DriftDataset, cfg=None) -> nn.Module:
    if name in UNPORTED:
        raise NotImplementedError(
            f"model {name!r}: not ported yet (ROADMAP §1 'The model zoo and "
            f"transformer training')")
    if name not in _BUILDERS:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{available_models()}")
    return _BUILDERS[name](ds, cfg)
