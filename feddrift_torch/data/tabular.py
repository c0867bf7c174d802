"""Tabular streaming datasets: UCI SUSY / Room-Occupancy and StackOverflow-LR.

A copy of ``feddrift_tpu/data/tabular.py``: the same config and seed give
bitwise-equal ``x``, ``y`` and ``concepts``.

- UCI SUSY / RO (``generate_uci_drift``): rows of the reference's CSV
  layouts under ``data_dir`` where the file exists (``SUSY.csv``: label,
  then 18 features; ``datatraining.txt``: id, date, 5 features, label; a
  header or malformed row is skipped), standardised and sliced per
  (client, step) in file order, a drifted concept k flipping the labels of
  the half-space ``x @ plane_k > 0``; else Gaussian rows labelled by
  concept k's own hyperplane.
- stackoverflow_lr (``generate_stackoverflow_lr_drift``): bag-of-words tag
  prediction. The TFF StackOverflow files under ``data_dir`` are read
  where all three are present (``stackoverflow/datasets/
  stackoverflow_train.h5``, ``stackoverflow.word_count``,
  ``stackoverflow.tag_count``): word-count vectors over the
  frequency-ranked vocabulary, the principal known tag as the label, at
  most 100,000 samples, sliced per (client, step) in file order (``h5py``
  imported only then). Else each tag is a peaked topic over the
  vocabulary and a sample ~30 word draws of its tag's topic. Either way a
  concept permutes the tag assignment (``meta["real_data"]`` is true on
  the real path).

Scale note: the reference's stackoverflow vocabulary is 10000 with 500 tag
classes; dense [C, T, N, F] storage makes that ~2 GB per 10-client run, so
the default here is vocab 1000 / 50 tags (``ExperimentConfig.so_vocab_size``
/ ``so_tag_size``).
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from feddrift_torch.data.changepoints import concept_matrix
from feddrift_torch.data.drift_dataset import DriftDataset, open_h5
from feddrift_torch.data.text import iter_tff_clients, load_word_ranks

UCI_SPECS = {
    # name: (feature_dim, csv filename under data_dir)
    "susy": (18, "SUSY.csv"),
    "ro": (5, "datatraining.txt"),
}

def _load_uci_csv(path: str, name: str, feature_dim: int,
                  max_rows: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Reference CSV layouts: SUSY rows are [label, 18 features]; RO rows are
    [id, date, 5 features, label]. At most ``max_rows`` accepted rows; a row
    that fails to parse (a header, a malformed row) is skipped whole."""
    if not os.path.exists(path):
        return None
    xs, ys = [], []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(xs) >= max_rows:
                break
            try:
                if name == "susy":
                    label = int(float(row[0]))
                    feats = [float(v) for v in row[1:1 + feature_dim]]
                else:
                    feats = [float(v) for v in row[2:2 + feature_dim]]
                    label = int(float(row[-1]))
            except (ValueError, IndexError):
                continue
            xs.append(feats)
            ys.append(label)
    if not xs:
        return None
    return (np.asarray(xs, dtype=np.float32),
            np.asarray(ys, dtype=np.int32))


def generate_uci_drift(
    name: str,
    change_points: np.ndarray,
    train_iterations: int,
    num_clients: int,
    sample_num: int,
    noise_prob: float = 0.0,
    time_stretch: int = 1,
    seed: int = 0,
    data_dir: str | None = None,
) -> DriftDataset:
    """SUSY / Room-Occupancy as a drifting binary-classification stream,
    ``[C, T+1, N, F]``: the CSV's rows where it exists under ``data_dir``
    (concept 0 keeps the true labels), else synthetic rows."""
    feature_dim, fname = UCI_SPECS[name]
    T = train_iterations
    rng = np.random.default_rng(seed)
    concepts = concept_matrix(change_points, T + 1, num_clients, time_stretch)
    n_concepts = max(int(concepts.max()) + 1, 2)
    crng = np.random.default_rng(3571)
    # per-concept random unit normal vectors (decision hyperplanes)
    planes = crng.normal(size=(n_concepts, feature_dim)).astype(np.float32)
    planes /= np.linalg.norm(planes, axis=1, keepdims=True)

    real = None
    if data_dir:
        real = _load_uci_csv(os.path.join(data_dir, fname), name, feature_dim,
                             max_rows=num_clients * (T + 1) * sample_num)
    x = np.zeros((num_clients, T + 1, sample_num, feature_dim), np.float32)
    y = np.zeros((num_clients, T + 1, sample_num), np.int32)
    if real is not None:
        rx, ry = real
        mu, sd = rx.mean(0), rx.std(0) + 1e-6
        rx = (rx - mu) / sd
        idx = 0
        for t in range(T + 1):
            for c in range(num_clients):
                take = np.arange(idx, idx + sample_num) % len(rx)
                idx += sample_num
                xi = rx[take]
                k = int(concepts[t, c]) % n_concepts
                x[c, t] = xi
                yi = ry[take].copy()
                if k > 0:       # drift: flip labels of the k-th half-space
                    flip = xi @ planes[k] > 0
                    yi = np.where(flip, 1 - yi, yi)
                y[c, t] = yi.astype(np.int32)
    else:
        for t in range(T + 1):
            for c in range(num_clients):
                k = int(concepts[t, c]) % n_concepts
                xi = rng.normal(size=(sample_num, feature_dim)).astype(
                    np.float32)
                x[c, t] = xi
                y[c, t] = (xi @ planes[k] > 0).astype(np.int32)
    if noise_prob > 0:
        flip = rng.random(y.shape) < noise_prob
        y = np.where(flip, 1 - y, y).astype(np.int32)
    return DriftDataset(x=x, y=y, num_classes=2, concepts=concepts,
                        name=name, meta={"source": "csv" if real is not None
                                         else "synthetic"})


def _try_load_stackoverflow_lr(
    data_dir: str, vocab_size: int, tag_size: int,
    max_samples: int = 100_000,
) -> tuple[np.ndarray, np.ndarray] | None:
    """The TFF StackOverflow files as (bag-of-words ``[N, vocab]``,
    principal tag ``[N]``), or None unless all three are present:
    ``stackoverflow_train.h5`` (``examples/<client>/{tokens,title,tags}``
    byte strings), ``stackoverflow.word_count`` ("word count" a line,
    ranked by frequency) and ``stackoverflow.tag_count`` (a JSON dict in
    count order). A sample none of whose tags is among the first
    ``tag_size`` is skipped; at most ``max_samples`` are read, client by
    client."""
    base = os.path.join(data_dir, "stackoverflow", "datasets")
    h5path = os.path.join(base, "stackoverflow_train.h5")
    wcpath = os.path.join(base, "stackoverflow.word_count")
    tcpath = os.path.join(base, "stackoverflow.tag_count")
    if not all(os.path.isfile(p) for p in (h5path, wcpath, tcpath)):
        return None
    word_id = {w: i
               for i, w in enumerate(load_word_ranks(wcpath, vocab_size))}
    with open(tcpath) as fh:
        tag_id = {t: i for i, t in enumerate(list(json.load(fh))[:tag_size])}
    X, Y = [], []
    with open_h5(h5path) as f:
        for ex in iter_tff_clients(f):
            if len(X) >= max_samples:
                break
            titles = ex["title"][()] if "title" in ex \
                else [b""] * len(ex["tokens"])
            for tok, tit, tag in zip(ex["tokens"][()], titles,
                                     ex["tags"][()]):
                tags = [tag_id[t] for t in tag.decode("utf8").split("|")
                        if t in tag_id]
                if not tags:
                    continue
                vec = np.zeros(vocab_size, np.float32)
                words = tok.decode("utf8") + " " + tit.decode("utf8")
                for w in words.split():
                    if w in word_id:
                        vec[word_id[w]] += 1.0
                X.append(vec)
                Y.append(tags[0])
    if not X:
        return None
    return np.stack(X), np.asarray(Y, np.int32)


def generate_stackoverflow_lr_drift(
    change_points: np.ndarray,
    train_iterations: int,
    num_clients: int,
    sample_num: int,
    noise_prob: float = 0.0,
    time_stretch: int = 1,
    seed: int = 0,
    vocab_size: int = 1000,
    tag_size: int = 50,
    data_dir: str = "./data",
) -> DriftDataset:
    """Bag-of-words tag prediction under drift, ``x [C, T+1, N, vocab]``
    word counts and ``y`` the principal tag: the TFF files' samples in
    order where they are present under ``data_dir``; else each tag class
    has a sparse topic distribution over the vocabulary (20 signature
    words) and a sample is ~30 tokens drawn from its tag's topic. A concept
    permutes the tag assignment (concept 0: the identity)."""
    T = train_iterations
    rng = np.random.default_rng(seed)
    concepts = concept_matrix(change_points, T + 1, num_clients, time_stretch)
    n_concepts = max(int(concepts.max()) + 1, 2)

    real = _try_load_stackoverflow_lr(data_dir, vocab_size, tag_size)
    if real is not None:
        rx, ry = real
        trng = np.random.default_rng(7793)
        perms = np.stack(
            [np.arange(tag_size)] +
            [trng.permutation(tag_size) for _ in range(n_concepts - 1)])
        x = np.zeros((num_clients, T + 1, sample_num, vocab_size),
                     np.float32)
        y = np.zeros((num_clients, T + 1, sample_num), np.int32)
        used = 0
        for t in range(T + 1):
            for c in range(num_clients):
                k = int(concepts[t, c]) % n_concepts
                take = np.arange(used, used + sample_num) % len(rx)
                used = (used + sample_num) % len(rx)
                x[c, t] = rx[take]
                y[c, t] = perms[k][ry[take]]
        if noise_prob > 0:
            flip = rng.random(y.shape) < noise_prob
            y = np.where(flip, rng.integers(0, tag_size, size=y.shape),
                         y).astype(np.int32)
        return DriftDataset(x=x, y=y, num_classes=tag_size,
                            concepts=concepts, name="stackoverflow_lr",
                            meta={"real_data": True})

    trng = np.random.default_rng(7793)
    # per-tag topic: a peaked distribution over 20 signature words + noise
    topics = np.full((tag_size, vocab_size), 0.05 / vocab_size, np.float64)
    for k in range(tag_size):
        sig = trng.choice(vocab_size, size=20, replace=False)
        topics[k, sig] += 0.95 / 20
    topics /= topics.sum(axis=1, keepdims=True)
    # per-concept tag permutation (concept 0 = identity)
    perms = np.stack([np.arange(tag_size)] +
                     [trng.permutation(tag_size)
                      for _ in range(n_concepts - 1)])

    x = np.zeros((num_clients, T + 1, sample_num, vocab_size), np.float32)
    y = np.zeros((num_clients, T + 1, sample_num), np.int32)
    for t in range(T + 1):
        for c in range(num_clients):
            k = int(concepts[t, c]) % n_concepts
            tags = rng.integers(0, tag_size, size=sample_num)
            for i, tag in enumerate(tags):
                words = rng.choice(vocab_size, size=30, p=topics[tag])
                np.add.at(x[c, t, i], words, 1.0)
            y[c, t] = perms[k][tags].astype(np.int32)
    if noise_prob > 0:
        flip = rng.random(y.shape) < noise_prob
        y = np.where(flip, rng.integers(0, tag_size, size=y.shape), y)
        y = y.astype(np.int32)
    return DriftDataset(x=x, y=y, num_classes=tag_size, concepts=concepts,
                        name="stackoverflow_lr")
