"""Party-split datasets for vertical federated learning.

A copy of ``feddrift_tpu/data/vertical_data.py``: the same seed (or files)
gives bitwise-equal party arrays and labels. NUS-WIDE two/three-party
loading (party A the 634-dim low-level image features, party B the
1000-dim tag vector, labels the top-k categories) and Lending-Club loan
data (qualification features against loan-profile features, a good/bad
loan label).

Real files are read where they are present under ``data_dir``: NUS-WIDE's
``Groundtruth`` / ``Low_Level_Features`` / ``NUS_WID_Tags`` layout (through
pandas, imported only then) and Lending Club's ``loan_processed.csv``;
otherwise the party features are synthetic, at the reference's widths,
with a shared class-dependent latent factor so that the parties
correlate. Each loader returns ``(party_features, y)``: a list of
``[N, F_p]`` float32 arrays, one a party, and int32 labels.
"""

from __future__ import annotations

import os

import numpy as np

# Reference dimensionalities.
NUS_WIDE_XA_DIM = 634    # low-level image features (nus_wide_dataset.py "634 columns")
NUS_WIDE_XB_DIM = 1000   # tag vector (get_labeled_data_with_2_party XB)
LENDING_QUAL_DIM = 17    # qualification_feat group (lending_club_feature_group.py)
LENDING_LOAN_DIM = 25    # loan/profile feature groups


def _synth_parties(dims: list[int], n: int, num_classes: int,
                   seed: int) -> tuple[list[np.ndarray], np.ndarray]:
    """Correlated party features: shared class-dependent latent + party noise."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    latent = rng.normal(size=(num_classes, 16)).astype(np.float32)[y]
    latent += rng.normal(0, 0.5, size=latent.shape).astype(np.float32)
    parties = []
    for p, d in enumerate(dims):
        proj = np.random.default_rng(11 + p).normal(
            size=(16, d)).astype(np.float32) / 4.0
        parties.append(latent @ proj +
                       rng.normal(0, 0.3, size=(n, d)).astype(np.float32))
    return parties, y


def load_nus_wide(data_dir: str | None = None, n_samples: int = 2000,
                  num_parties: int = 2, top_k: int = 5,
                  seed: int = 0) -> tuple[list[np.ndarray], np.ndarray]:
    """NUS-WIDE party split. Two-party: [image 634, tags 1000]; three-party
    additionally splits the image features (first 300 / rest), mirroring the
    guest/host split of the reference's three-party VFL experiment."""
    if data_dir and os.path.isdir(os.path.join(data_dir, "Low_Level_Features")):
        xa, xb, y = _load_nus_wide_files(data_dir, top_k, n_samples)
    else:
        (xa, xb), y = _synth_parties([NUS_WIDE_XA_DIM, NUS_WIDE_XB_DIM],
                                     n_samples, top_k, seed)
    if num_parties == 2:
        return [xa, xb], y
    return [xa[:, :300], xa[:, 300:], xb], y


def _load_nus_wide_files(data_dir: str, top_k: int,
                         n_samples: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    import pandas as pd  # lazy: only on the real-data path
    label_dir = os.path.join(data_dir, "Groundtruth", "TrainTestLabels")
    labels = sorted(f.split("_")[1] for f in os.listdir(label_dir)
                    if f.endswith("_Train.txt"))[:top_k]
    dfs = [pd.read_csv(os.path.join(label_dir, f"Labels_{l}_Train.txt"),
                       header=None, names=[l]) for l in labels]
    lab = pd.concat(dfs, axis=1)
    sel = lab[lab.sum(axis=1) == 1].index[:n_samples]
    y = lab.loc[sel].to_numpy().argmax(1).astype(np.int32)
    feat_dir = os.path.join(data_dir, "Low_Level_Features")
    fdfs = [pd.read_csv(os.path.join(feat_dir, f), header=None, sep=" ").dropna(axis=1)
            for f in sorted(os.listdir(feat_dir)) if f.startswith("Train_Normalized")]
    xa = pd.concat(fdfs, axis=1).loc[sel].to_numpy().astype(np.float32)
    xb_path = os.path.join(data_dir, "NUS_WID_Tags", "Train_Tags1k.dat")
    xb = pd.read_csv(xb_path, header=None, sep="\t").dropna(axis=1) \
        .loc[sel].to_numpy().astype(np.float32)
    return xa, xb, y


def load_lending_club(data_dir: str | None = None, n_samples: int = 4000,
                      num_parties: int = 2,
                      seed: int = 0) -> tuple[list[np.ndarray], np.ndarray]:
    """Lending-club loan party split: qualification features vs. loan profile,
    binary good/bad-loan label (loan_load_two_party_data). Three-party splits
    the loan profile in half (loan_load_three_party_data)."""
    path = data_dir and os.path.join(data_dir, "loan_processed.csv")
    if path and os.path.exists(path):
        raw = np.loadtxt(path, delimiter=",", skiprows=1,
                         max_rows=n_samples).astype(np.float32)
        xq, xl, y = (raw[:, :LENDING_QUAL_DIM],
                     raw[:, LENDING_QUAL_DIM:LENDING_QUAL_DIM + LENDING_LOAN_DIM],
                     raw[:, -1].astype(np.int32))
    else:
        (xq, xl), y = _synth_parties([LENDING_QUAL_DIM, LENDING_LOAN_DIM],
                                     n_samples, 2, seed)
    if num_parties == 2:
        return [xq, xl], y
    h = LENDING_LOAN_DIM // 2
    return [xq, xl[:, :h], xl[:, h:]], y
