"""Character-sequence drift data (the synthetic Markov path).

Copy of ``feddrift_tpu/data/text.py::generate_text_drift``'s hermetic path:
each concept is a distinct seeded Markov chain over the 90-id character
vocabulary, and a drift changes the transition matrix. Sequences are token
ids ``[seq_len]`` with the next character as label. The numpy draws are the
reference's, in the same order, so the arrays are bitwise equal to it for
the same arguments.

The reference prefers a real corpus (TFF h5 or LEAF JSON) under
``data_dir`` when one is present; those loaders are not ported yet, so this
module refuses such a directory instead of silently producing other data.
"""

from __future__ import annotations

import os

import numpy as np

from feddrift_torch.data.changepoints import concept_matrix
from feddrift_torch.data.drift_dataset import DriftDataset

VOCAB_SIZE = 90   # reference rnn.py:18
SEQ_LEN = 80      # reference LEAF shakespeare sequence length

_CORPUS_PATHS = (("fed_shakespeare", "datasets", "shakespeare_train.h5"),
                 ("shakespeare", "train"))


def _concept_transition(concept: int, vocab: int) -> np.ndarray:
    """Row-stochastic transition matrix, deterministic per concept: ~0.5
    mass on the top successor (geometric weights over 8 successors)."""
    rng = np.random.default_rng(7919 + concept)
    logits = rng.normal(0, 1, size=(vocab, vocab))
    top = np.argsort(logits, axis=1)[:, -8:]
    mat = np.full((vocab, vocab), 1e-3)
    weights = 0.5 ** np.arange(8)[::-1]     # argsort ascending: last = top-1
    for i in range(vocab):
        mat[i, top[i]] += weights
    return mat / mat.sum(axis=1, keepdims=True)


def generate_text_drift(
    change_points: np.ndarray,
    train_iterations: int,
    num_clients: int,
    sample_num: int,
    noise_prob: float = 0.0,
    time_stretch: int = 1,
    seed: int = 0,
    seq_len: int = SEQ_LEN,
    vocab: int = VOCAB_SIZE,
    data_dir: str = "./data",
) -> DriftDataset:
    for parts in _CORPUS_PATHS:
        path = os.path.join(data_dir, *parts)
        if os.path.exists(path):
            raise NotImplementedError(
                f"real-corpus text data ({path}) is not ported yet (ROADMAP "
                f"§1 'The other datasets'); point data_dir elsewhere for the "
                f"synthetic Markov data")
    rng = np.random.default_rng(seed)
    T = train_iterations

    n_concepts = int(change_points.max()) + 1
    chains = [_concept_transition(k, vocab) for k in range(max(n_concepts, 2))]

    x = np.zeros((num_clients, T + 1, sample_num, seq_len), dtype=np.int32)
    y = np.zeros((num_clients, T + 1, sample_num), dtype=np.int32)
    concepts = concept_matrix(change_points, T + 1, num_clients, time_stretch)
    for t in range(T + 1):
        for c in range(num_clients):
            concept = int(concepts[t, c])
            P = chains[concept % len(chains)]
            # Vectorised Markov rollout: [N, seq_len + 1]
            seq = np.zeros((sample_num, seq_len + 1), dtype=np.int32)
            seq[:, 0] = rng.integers(1, vocab, size=sample_num)
            u = rng.random((sample_num, seq_len))
            cdf = np.cumsum(P, axis=1)
            for s in range(seq_len):
                seq[:, s + 1] = (u[:, s, None] < cdf[seq[:, s]]).argmax(axis=1)
            x[c, t] = seq[:, :seq_len]
            ys = seq[:, seq_len]
            if noise_prob > 0:
                flip = rng.random(sample_num) < noise_prob
                ys = np.where(flip, rng.integers(0, vocab, size=sample_num), ys)
            y[c, t] = ys
    return DriftDataset(x=x, y=y, num_classes=vocab, concepts=concepts,
                        name="shakespeare", is_sequence=True,
                        meta={"vocab": vocab, "seq_len": seq_len})
