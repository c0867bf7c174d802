"""Model registry of the port: ``create_model(name, ds, cfg)``.

Mirrors ``feddrift_tpu/models/__init__.py``. The ``lr``, ``fnn`` and
``transformer`` entries are ported so far, with the registry's exact sizes;
any other name raises ``KeyError``.
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


@register_model("transformer")
def _transformer(ds: DriftDataset, cfg) -> nn.Module:
    from feddrift_torch.models.transformer import TransformerLM
    return TransformerLM(vocab_size=ds.num_classes,
                         max_len=max(ds.feature_shape[0]
                                     if ds.is_sequence else 128, 128))


def create_model(name: str, ds: DriftDataset, cfg=None) -> nn.Module:
    if name not in _BUILDERS:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{available_models()}")
    return _BUILDERS[name](ds, cfg)
