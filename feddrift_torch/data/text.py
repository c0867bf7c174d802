"""Token-sequence drift data: character (Shakespeare) and word
(StackOverflow next-word) datasets.

A copy of ``feddrift_tpu/data/text.py``: the same files and seed give
bitwise-equal ``x``, ``y``, ``concepts`` and ``meta``. Sequences are token
ids ``[seq_len]`` (int32) with the next token as label.

A real corpus under ``data_dir`` is read where it is present:

- ``fed_shakespeare/datasets/shakespeare_train.h5``: the TFF h5 layout
  (``examples/<client>/snippets``), each snippet bos + ids + eos;
- else ``shakespeare/train/*.json``: the LEAF layout (users / user_data
  x, y sentence strings), each sentence and its next character + eos;
- ``stackoverflow/datasets/stackoverflow_train.h5`` with
  ``stackoverflow.word_count``: the TFF word layout
  (``examples/<client>/tokens``), words ranked by frequency.

Characters map through ``CHAR_VOCAB`` (unknown ones to ``OOV_ID``); at
most ``_MAX_CORPUS_IDS`` ids are read. Windows of ``seq_len + 1`` ids are
drawn from the corpus, and concept k rotates every id by ``31 * k`` modulo
the vocabulary. ``h5py`` is imported only when an h5 file is present
(``drift_dataset.open_h5``), and a present file that the host cannot read
raises.

Where no corpus is present, the data are synthetic:

- ``generate_text_drift`` (``shakespeare`` / ``fed_shakespeare``): each
  concept is a distinct seeded Markov chain over the 90-id character
  vocabulary, and a drift changes the transition matrix;
- ``generate_word_drift`` (``stackoverflow`` / ``stackoverflow_nwp``):
  each concept is an affine language over the 10000-word vocabulary,
  next = (a_k·cur + b_k) mod V with 10 % uniform noise a step, and a drift
  changes (a_k, b_k).
"""

from __future__ import annotations

import json
import os

import numpy as np

from feddrift_torch.data.changepoints import concept_matrix
from feddrift_torch.data.drift_dataset import DriftDataset, open_h5

VOCAB_SIZE = 90   # reference rnn.py:18
SEQ_LEN = 80      # reference LEAF shakespeare sequence length

# The TFF character vocabulary (fed_shakespeare/utils.py::CHAR_VOCAB, 86
# chars) plus the four structural slots (pad / bos / eos / oov) = 90 ids,
# matching the CharLSTM's embedding table (rnn.py:18). LEAF-JSON text is
# mapped through the same table (unknown chars -> oov) so both on-disk
# formats produce one id space.
CHAR_VOCAB = ('dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#\'/37;?bfjnrvzBFJNRVZ"&*.26:'
              '\naeimquyAEIMQUY]!%)-159\r')
PAD_ID = 0
BOS_ID = len(CHAR_VOCAB) + 1    # 87
EOS_ID = len(CHAR_VOCAB) + 2    # 88
OOV_ID = len(CHAR_VOCAB) + 3    # 89
_CHAR_TO_ID = {ch: i + 1 for i, ch in enumerate(CHAR_VOCAB)}


def _char_ids(text: str) -> np.ndarray:
    return np.array([_CHAR_TO_ID.get(ch, OOV_ID) for ch in text], np.int32)


def load_word_ranks(path: str, k: int) -> list[str]:
    """Top-k words of a TFF ``word_count`` file ("word count" per line,
    frequency-ranked — the reference's get_most_frequent_words,
    stackoverflow_lr/utils.py:15-19). Shared by the NWP and LR loaders."""
    with open(path) as fh:
        return [ln.split()[0] for ln in fh if ln.strip()][:k]


def iter_tff_clients(h5file):
    """Yield the ``examples/<client>`` groups of a TFF-layout h5 in sorted
    client-key order (deterministic corpus identity across runs)."""
    for cid in sorted(h5file["examples"].keys()):
        yield h5file["examples"][cid]


# Window sampling only ever consumes C * (T+1) * sample_num windows, so a
# bounded prefix of a huge on-disk corpus (full TFF StackOverflow is ~1.7B
# tokens) gives identical coverage without materializing the whole stream.
_MAX_CORPUS_IDS = 2_000_000


def _try_load_char_corpus(data_dir: str, min_len: int,
                          max_len: int = _MAX_CORPUS_IDS) -> np.ndarray | None:
    """Real Shakespeare as one id stream, or None if no files are present."""
    h5path = os.path.join(data_dir, "fed_shakespeare", "datasets",
                          "shakespeare_train.h5")
    chunks: list[np.ndarray] = []
    total = 0
    if os.path.isfile(h5path):
        with open_h5(h5path) as f:
            for ex in iter_tff_clients(f):
                if total >= max_len:
                    break
                for snip in ex["snippets"][()]:
                    ids = _char_ids(snip.decode("utf8"))
                    chunks.append(np.concatenate(
                        [[BOS_ID], ids, [EOS_ID]]).astype(np.int32))
                    total += len(chunks[-1])
                    if total >= max_len:
                        break
    else:
        jdir = os.path.join(data_dir, "shakespeare", "train")
        if os.path.isdir(jdir):
            for fn in sorted(os.listdir(jdir)):
                if not fn.endswith(".json") or total >= max_len:
                    continue
                with open(os.path.join(jdir, fn)) as fh:
                    d = json.load(fh)
                for u in d["users"]:
                    if total >= max_len:
                        break
                    ud = d["user_data"][u]
                    for sent, nxt in zip(ud["x"], ud["y"]):
                        chunks.append(np.concatenate(
                            [_char_ids(sent + nxt), [EOS_ID]]
                        ).astype(np.int32))
                        total += len(chunks[-1])
    if not chunks:
        return None
    corpus = np.concatenate(chunks)[:max_len]
    return corpus if len(corpus) >= min_len else None


def _try_load_word_corpus(data_dir: str, vocab: int, min_len: int,
                          max_len: int = _MAX_CORPUS_IDS) -> np.ndarray | None:
    """Real StackOverflow token stream (TFF h5 + word_count vocab file)."""
    base = os.path.join(data_dir, "stackoverflow", "datasets")
    h5path = os.path.join(base, "stackoverflow_train.h5")
    wcpath = os.path.join(base, "stackoverflow.word_count")
    if not (os.path.isfile(h5path) and os.path.isfile(wcpath)):
        return None
    # word ids 1..vocab-2 by corpus frequency rank;
    # 0 is reserved (pad), vocab-1 is the oov bucket.
    word_id = {w: i + 1
               for i, w in enumerate(load_word_ranks(wcpath, vocab - 2))}
    ids: list[int] = []
    with open_h5(h5path) as f:
        for ex in iter_tff_clients(f):
            if len(ids) >= max_len:
                break
            for sent in ex["tokens"][()]:
                ids.extend(word_id.get(w, vocab - 1)
                           for w in sent.decode("utf8").split())
                if len(ids) >= max_len:
                    break
    if len(ids) < min_len:
        return None
    return np.asarray(ids[:max_len], np.int32)


def _real_text_windows(
    corpus: np.ndarray,
    concepts: np.ndarray,
    num_clients: int,
    sample_num: int,
    seq_len: int,
    vocab: int,
    rng: np.random.Generator,
    noise_prob: float,
    name: str,
) -> DriftDataset:
    """Serve (seq_len+1)-char windows of a real corpus; concept k rotates
    the alphabet (see module docstring)."""
    T1 = concepts.shape[0]
    x = np.zeros((num_clients, T1, sample_num, seq_len), np.int32)
    y = np.zeros((num_clients, T1, sample_num), np.int32)
    for t in range(T1):
        for c in range(num_clients):
            k = int(concepts[t, c])
            # valid starts: 0 .. len-seq_len-1 inclusive (window is
            # seq_len+1 ids); integers() high bound is exclusive
            starts = rng.integers(0, len(corpus) - seq_len,
                                  size=sample_num)
            win = corpus[starts[:, None] + np.arange(seq_len + 1)]
            if k:
                win = (win + 31 * k) % vocab
            x[c, t] = win[:, :seq_len]
            ys = win[:, seq_len].copy()
            if noise_prob > 0:
                flip = rng.random(sample_num) < noise_prob
                ys = np.where(flip, rng.integers(0, vocab, size=sample_num),
                              ys).astype(np.int32)
            y[c, t] = ys
    return DriftDataset(x=x, y=y, num_classes=vocab, concepts=concepts,
                        name=name, is_sequence=True,
                        meta={"vocab": vocab, "seq_len": seq_len,
                              "real_data": True})


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
    rng = np.random.default_rng(seed)
    T = train_iterations

    corpus = _try_load_char_corpus(data_dir, min_len=seq_len + 2)
    if corpus is not None:
        concepts = concept_matrix(change_points, T + 1, num_clients,
                                  time_stretch)
        return _real_text_windows(corpus, concepts, num_clients, sample_num,
                                  seq_len, vocab, rng, noise_prob,
                                  "shakespeare")

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


def generate_word_drift(
    change_points: np.ndarray,
    train_iterations: int,
    num_clients: int,
    sample_num: int,
    noise_prob: float = 0.0,
    time_stretch: int = 1,
    seed: int = 0,
    seq_len: int = 20,
    vocab: int = 10000,
    data_dir: str = "./data",
) -> DriftDataset:
    rng = np.random.default_rng(seed)
    T = train_iterations

    corpus = _try_load_word_corpus(data_dir, vocab, min_len=seq_len + 2)
    if corpus is not None:
        concepts = concept_matrix(change_points, T + 1, num_clients,
                                  time_stretch)
        return _real_text_windows(corpus, concepts, num_clients, sample_num,
                                  seq_len, vocab, rng, noise_prob,
                                  "stackoverflow_nwp")

    n_concepts = max(int(change_points.max()) + 1, 2)
    crng = np.random.default_rng(104729)
    a = crng.integers(2, vocab - 1, size=n_concepts)
    b = crng.integers(0, vocab, size=n_concepts)

    x = np.zeros((num_clients, T + 1, sample_num, seq_len), dtype=np.int32)
    y = np.zeros((num_clients, T + 1, sample_num), dtype=np.int32)
    concepts = concept_matrix(change_points, T + 1, num_clients, time_stretch)
    for t in range(T + 1):
        for c in range(num_clients):
            k = int(concepts[t, c]) % n_concepts
            seq = np.zeros((sample_num, seq_len + 1), dtype=np.int64)
            seq[:, 0] = rng.integers(0, vocab, size=sample_num)
            noise = rng.random((sample_num, seq_len)) < 0.1
            repl = rng.integers(0, vocab, size=(sample_num, seq_len))
            for s in range(seq_len):
                nxt = (a[k] * seq[:, s] + b[k]) % vocab
                seq[:, s + 1] = np.where(noise[:, s], repl[:, s], nxt)
            x[c, t] = seq[:, :seq_len].astype(np.int32)
            ys = seq[:, seq_len].astype(np.int32)
            if noise_prob > 0:
                flip = rng.random(sample_num) < noise_prob
                ys = np.where(flip, rng.integers(0, vocab, size=sample_num),
                              ys)
            y[c, t] = ys
    return DriftDataset(x=x, y=y, num_classes=vocab, concepts=concepts,
                        name="stackoverflow_nwp", is_sequence=True,
                        meta={"vocab": vocab, "seq_len": seq_len})
