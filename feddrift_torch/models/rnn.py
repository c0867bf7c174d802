"""The LSTM sequence models: ``CharLSTM`` (``rnn``) and ``WordLSTM``
(``rnn_stackoverflow``).

Counterparts of ``feddrift_tpu/models/rnn.py`` (flax). Leaf names and
layouts are flax's (``Embed_0/embedding [V, E]``,
``OptimizedLSTMCell_0/ii/kernel [in, H]``, ``OptimizedLSTMCell_0/hi/kernel
[H, H]``, ``OptimizedLSTMCell_0/hi/bias [H]``, ``Dense_0/kernel [in,
out]``), with flax's initialisers. Both take token
ids ``x [N, L]`` (int32, or float after a feature mask) and return the
logits of the token after the last position, from the last step's hidden
state. Each LSTM step's cell is ``kernels/lstm_cell.py::lstm_cell``.

Both define ``pair_logits``: P models' leaves ``[P, ...]`` on their own
rows ``x [P, N, L]`` in one batched program (a row's logits depend on its
own tokens alone), which ``model_local_sgd`` differentiates by plain
autograd; ``forward`` is its one-model case.
"""

from __future__ import annotations

import torch

from feddrift_torch.models.base import (GenericNet, Params, lstm_specs,
                                        pair_dense, pair_embed, pair_lstm)


def _one(module, params: Params, x: torch.Tensor) -> torch.Tensor:
    """One model's leaves on ``x [N, L]``: ``pair_logits`` of one pair."""
    return module.pair_logits({k: v[None] for k, v in params.items()},
                              x[None])[0]


class CharLSTM(GenericNet):
    """Embed(V, 8) -> LSTM 256 -> LSTM 256 -> Dense(V) on the last step;
    820,522 params at fed_shakespeare's V = 90."""

    def __init__(self, feature_shape: tuple[int, ...], vocab_size: int = 90,
                 embedding_dim: int = 8, hidden_size: int = 256) -> None:
        super().__init__()
        self.feature_shape = tuple(feature_shape)
        self.num_classes = vocab_size
        self.embedding_dim, self.hidden_size = embedding_dim, hidden_size

    def param_specs(self):
        V, E, H = self.num_classes, self.embedding_dim, self.hidden_size
        return {"Embed_0/embedding": ((V, E), "embed"),
                **lstm_specs("OptimizedLSTMCell_0", E, H),
                **lstm_specs("OptimizedLSTMCell_1", H, H),
                "Dense_0/kernel": ((H, V), "lecun_normal"),
                "Dense_0/bias": ((V,), "zeros")}

    def pair_logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = pair_lstm(pair_embed(x, params, "Embed_0"), params,
                      "OptimizedLSTMCell_0")
        h = pair_lstm(h, params, "OptimizedLSTMCell_1", sequence=False)
        return pair_dense(h, params, "Dense_0")

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return _one(self, params, x)


class WordLSTM(GenericNet):
    """Embed(V + 4, 96) -> LSTM 670 -> Dense 96 -> Dense(V + 4) on the last
    step (V words, pad / bos / eos and one out-of-vocabulary bucket);
    4,050,748 params at stackoverflow_nwp's V = 10000."""

    def __init__(self, feature_shape: tuple[int, ...],
                 vocab_size: int = 10000, num_oov_buckets: int = 1,
                 embedding_size: int = 96, latent_size: int = 670) -> None:
        super().__init__()
        self.feature_shape = tuple(feature_shape)
        self.num_classes = vocab_size + 3 + num_oov_buckets
        self.embedding_size, self.latent_size = embedding_size, latent_size

    def param_specs(self):
        V, E, H = self.num_classes, self.embedding_size, self.latent_size
        return {"Embed_0/embedding": ((V, E), "embed"),
                **lstm_specs("OptimizedLSTMCell_0", E, H),
                "Dense_0/kernel": ((H, E), "lecun_normal"),
                "Dense_0/bias": ((E,), "zeros"),
                "Dense_1/kernel": ((E, V), "lecun_normal"),
                "Dense_1/bias": ((V,), "zeros")}

    def pair_logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = pair_lstm(pair_embed(x, params, "Embed_0"), params,
                      "OptimizedLSTMCell_0", sequence=False)
        return pair_dense(pair_dense(h, params, "Dense_0"), params,
                          "Dense_1")

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return _one(self, params, x)
