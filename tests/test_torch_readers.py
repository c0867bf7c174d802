"""The port's real-file readers against the JAX package's on the CPU.

Both packages' ``make_dataset`` read the same files, written here in each
layout the reference reads (LEAF MNIST JSON, the TFF h5 of FederatedEMNIST
and fed_cifar100, the CIFAR python pickles of cifar10 and cifar100, a
cinic10 PNG tree, fed_shakespeare's h5, LEAF Shakespeare JSON, and the
StackOverflow next-word and bag-of-words h5 with their vocabularies):
``x``, ``y``, ``concepts``, ``meta`` and the rest are compared bitwise,
since both read with numpy and draw from numpy ``default_rng`` in the same
order. Where no file is present both make the same synthetic data; where
the reference raises (a PNG of the wrong size, an h5 it cannot open), the
port raises the same exception type. Also bitwise from seeds:
``data/partition.py`` and ``data/vertical_data.py``. Then what
``chip_smoke.py``'s ``train_readers`` stands on: the committed digits
(``tests/data/uci_digits.npz``) and the files
``scripts/torch_make_digits_files.py`` writes from them, the reference
inits at seeds 1 and 2, the pinned and gated card runs, and one round of
the MNIST fnn on LEAF files against the reference's ``train_round`` on its
own draws, at ``tests/test_torch_fmow.py``'s tolerances (float32: losses
and mu at atol 2e-6, nu at rtol 1e-4, AMSGrad's params at atol 2e-5, n
exactly).
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from feddrift_torch.config import ExperimentConfig as TorchConfig
from feddrift_torch.convert import params_from_jax
from feddrift_torch.data import partition as tpart
from feddrift_torch.data import prototype as tproto
from feddrift_torch.data import text as ttext
from feddrift_torch.data import vertical_data as tvert
from feddrift_torch.data.registry import make_dataset as torch_make
from feddrift_tpu.config import ExperimentConfig as JaxConfig
from feddrift_tpu.data import partition as jpart
from feddrift_tpu.data import prototype as jproto
from feddrift_tpu.data import text as jtext
from feddrift_tpu.data import vertical_data as jvert
from feddrift_tpu.data.registry import make_dataset as jax_make
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, T, N = 2, 2, 5


def _digits_script():
    spec = importlib.util.spec_from_file_location(
        "torch_make_digits_files",
        os.path.join(REPO, "scripts", "torch_make_digits_files.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kw(dataset, root, **over):
    kw = dict(dataset=dataset, model="fnn", concept_drift_algo="win-1",
              change_points="rand", drift_together=1, client_num_in_total=C,
              client_num_per_round=C, train_iterations=T, comm_round=1,
              sample_num=N, concept_num=2, data_dir=str(root))
    kw.update(over)
    return kw


def _same(got, want):
    assert got.x.dtype == want.x.dtype and got.y.dtype == want.y.dtype
    assert got.x.shape == want.x.shape
    assert np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)
    assert np.array_equal(got.concepts, want.concepts)
    assert got.meta == want.meta and got.name == want.name
    assert got.num_classes == want.num_classes
    assert got.is_sequence == want.is_sequence


# --------------------------------------------------------------------------
# The layouts, written small

def _leaf_mnist(root):
    rng = np.random.default_rng(7)
    d = root / "MNIST" / "train"
    d.mkdir(parents=True)
    xs, ys = rng.random((40, 784)).round(4), rng.integers(0, 10, 40)
    for i, (lo, hi) in enumerate(((0, 15), (15, 40))):
        users = [f"f_{i}a", f"f_{i}b"]
        mid = (lo + hi) // 2
        payload = {"users": users, "num_samples": [mid - lo, hi - mid],
                   "user_data": {
                       users[0]: {"x": xs[lo:mid].tolist(),
                                  "y": ys[lo:mid].tolist()},
                       users[1]: {"x": xs[mid:hi].tolist(),
                                  "y": ys[mid:hi].tolist()}}}
        (d / f"part_{i}.json").write_text(json.dumps(payload))
    (d / "README.txt").write_text("not json")


def _tff_images(root, sub, name, key, pixels, classes):
    h5py = pytest.importorskip("h5py")
    (root / sub).mkdir(parents=True)
    lab = np.random.default_rng(17).integers(0, classes, len(pixels))
    with h5py.File(root / sub / name, "w") as f:
        f.create_dataset(key, data=pixels)
        f.create_dataset("label", data=lab)
        f.create_dataset("id", data=np.arange(len(pixels)) % 3)


def _femnist_h5(root):
    px = np.random.default_rng(1).random((30, 28, 28)).astype(np.float32)
    _tff_images(root, "FederatedEMNIST", "emnist_train.h5", "pixels", px, 62)


def _fed_cifar100_h5(root):
    img = np.random.default_rng(2).integers(0, 256, (24, 32, 32, 3)) \
        .astype(np.uint8)
    _tff_images(root, "fed_cifar100", "cifar100_train.h5", "image", img, 100)


def _cifar10_pickles(root):
    rng = np.random.default_rng(23)
    d = root / "cifar-10-batches-py"
    d.mkdir()
    imgs = rng.integers(0, 256, (20, 3072)).astype(np.uint8)
    labs = rng.integers(0, 10, 20)
    for i in range(1, 5):          # data_batch_5 missing: skipped
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": imgs[(i - 1) * 5:i * 5],
                         b"labels": labs[(i - 1) * 5:i * 5].tolist()}, f)


def _cifar100_pickle(root):
    rng = np.random.default_rng(29)
    d = root / "cifar-100-python"
    d.mkdir()
    with open(d / "train", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (16, 3072))
                     .astype(np.uint8),
                     b"fine_labels": rng.integers(0, 100, 16).tolist()}, f)


def _cinic10_tree(root, size=32):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(31)
    for cls in ("bird", "airplane", "cat"):
        d = root / "cinic10" / "train" / cls
        d.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (size, size, 3))
                            .astype(np.uint8)).save(d / f"img_{i}.png")
        (d / "notes.txt").write_text("not an image")
    gray = root / "cinic10" / "train" / "dog"
    gray.mkdir()
    Image.fromarray(rng.integers(0, 256, (size, size)).astype(np.uint8),
                    mode="L").save(gray / "g.PNG")


SNIPPETS = [["to be or not to be that is the question",
             "all the worlds a stage æ and all the men players"],
            ["now is the winter of our discontent"]]


def _fed_shakespeare_h5(root):
    h5py = pytest.importorskip("h5py")
    d = root / "fed_shakespeare" / "datasets"
    d.mkdir(parents=True)
    with h5py.File(d / "shakespeare_train.h5", "w") as f:
        g = f.create_group("examples")
        for i, snips in enumerate(SNIPPETS):    # sorted key order differs
            g.create_group(f"client_{9 - i}").create_dataset(
                "snippets", data=[s.encode("utf8") for s in snips])


def _leaf_shakespeare(root):
    d = root / "shakespeare" / "train"
    d.mkdir(parents=True)
    users = {"ROMEO": (["but soft what light through yonder window break"],
                       ["s"]),
             "JULIET": (["deny thy father and refuse thy nam", "o romeo"],
                        ["e", "!"])}
    payload = {"users": list(users),
               "user_data": {u: {"x": x, "y": y}
                             for u, (x, y) in users.items()}}
    (d / "all_data_train_9.json").write_text(json.dumps(payload))


def _stackoverflow(root, lr: bool):
    h5py = pytest.importorskip("h5py")
    d = root / "stackoverflow" / "datasets"
    d.mkdir(parents=True)
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(44)]        # w40..w43: not counted
    sents = [" ".join(words[j] for j in rng.integers(0, 44, 30))
             for _ in range(8)]
    tags = ["python|jax", "tpu", "unknown", "xla|offtag", "jax", "python",
            "tpu|xla", "cuda"]
    with open(d / "stackoverflow.word_count", "w") as f:
        for i, w in enumerate(words[:40]):
            f.write(f"{w} {1000 - i}\n")
        f.write("\n")
    with open(d / "stackoverflow.tag_count", "w") as f:
        json.dump({t: 50 - i for i, t in enumerate(
            ["python", "jax", "tpu", "xla", "cuda"])}, f)
    with h5py.File(d / "stackoverflow_train.h5", "w") as f:
        g = f.create_group("examples")
        for c, sl in (("c1", slice(0, 4)), ("c0", slice(4, 8))):
            e = g.create_group(c)
            e.create_dataset("tokens",
                             data=[s.encode() for s in sents[sl]])
            e.create_dataset("tags", data=[t.encode() for t in tags[sl]])
            if c == "c1" and lr:
                e.create_dataset("title", data=[b"w1 w2", b"", b"w3",
                                                b"w39 w39"])


# (dataset, writer, configuration beyond _kw)
LAYOUTS = {
    "MNIST": (_leaf_mnist, {}),
    "femnist": (_femnist_h5, {}),
    "fed_cifar100": (_fed_cifar100_h5, {}),
    "cifar10": (_cifar10_pickles, {}),
    "cifar100": (_cifar100_pickle, {}),
    "cinic10": (_cinic10_tree, {}),
    "fed_shakespeare": (_fed_shakespeare_h5, {"text_seq_len": 8}),
    "shakespeare": (_leaf_shakespeare, {"text_seq_len": 8}),
    "stackoverflow_nwp": (lambda r: _stackoverflow(r, False), {}),
    "stackoverflow_lr": (lambda r: _stackoverflow(r, True),
                         {"so_vocab_size": 40, "so_tag_size": 4}),
}


@pytest.mark.parametrize("noise,seed", [(0.0, 0), (0.2, 3)])
@pytest.mark.parametrize("dataset", sorted(LAYOUTS))
def test_real_files_bitwise_equal_reference(dataset, noise, seed, tmp_path):
    """Each layout read by both packages' registries: bitwise the same
    dataset, and the real files were read (``meta["real_data"]``)."""
    write, extra = LAYOUTS[dataset]
    write(tmp_path)
    kw = _kw(dataset, tmp_path, noise_prob=noise, seed=seed, **extra)
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert got.meta["real_data"] is True
    _same(got, want)


@pytest.mark.parametrize("dataset", ["MNIST", "cifar10", "cinic10",
                                     "femnist"])
def test_smooth_ignores_real_files(dataset, tmp_path):
    """The -smooth family is always synthetic, real files or not, as the
    reference's is."""
    LAYOUTS[dataset][0](tmp_path)
    kw = _kw(dataset + "-smooth", tmp_path)
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert got.meta["real_data"] is False
    _same(got, want)


@pytest.mark.parametrize("dataset", sorted(LAYOUTS))
def test_absent_files_give_the_same_synthetic_data(dataset, tmp_path):
    kw = _kw(dataset, tmp_path / "empty", **LAYOUTS[dataset][1])
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert not got.meta.get("real_data", False)
    _same(got, want)


def _empty_layout(root, case):
    """A layout present but empty, or unreadable: what the reference then
    does, the port must do."""
    if case == "mnist_dir_without_json":
        (root / "MNIST" / "train").mkdir(parents=True)
        return "MNIST"
    if case == "mnist_json_without_users":
        (root / "MNIST" / "train").mkdir(parents=True)
        (root / "MNIST" / "train" / "a.json").write_text(
            json.dumps({"users": [], "user_data": {}}))
        return "MNIST"
    if case == "cifar10_dir_without_batches":
        (root / "cifar-10-batches-py").mkdir()
        return "cifar10"
    if case == "cinic10_tree_without_classes":
        (root / "cinic10" / "train").mkdir(parents=True)
        return "cinic10"
    if case == "cinic10_classes_without_png":
        (root / "cinic10" / "train" / "cat").mkdir(parents=True)
        (root / "cinic10" / "train" / "cat" / "x.jpg").write_bytes(b"x")
        return "cinic10"
    if case == "shakespeare_dir_without_json":
        (root / "shakespeare" / "train").mkdir(parents=True)
        return "shakespeare"
    if case == "femnist_h5_without_pixels":
        h5py = pytest.importorskip("h5py")
        (root / "FederatedEMNIST").mkdir()
        with h5py.File(root / "FederatedEMNIST" / "emnist_train.h5",
                       "w") as f:
            f.create_dataset("label", data=np.zeros(3, np.int64))
        return "femnist"
    if case == "femnist_h5_empty_file":
        (root / "FederatedEMNIST").mkdir()
        (root / "FederatedEMNIST" / "emnist_train.h5").write_bytes(b"")
        return "femnist"
    if case == "word_h5_empty_file":
        base = root / "stackoverflow" / "datasets"
        base.mkdir(parents=True)
        (base / "stackoverflow_train.h5").write_bytes(b"")
        (base / "stackoverflow.word_count").write_text("w 1\n")
        return "stackoverflow_nwp"
    if case == "so_lr_without_tag_count":
        base = root / "stackoverflow" / "datasets"
        base.mkdir(parents=True)
        (base / "stackoverflow_train.h5").write_bytes(b"")
        (base / "stackoverflow.word_count").write_text("w 1\n")
        return "stackoverflow_lr"
    raise KeyError(case)


EMPTY_CASES = ("mnist_dir_without_json", "mnist_json_without_users",
               "cifar10_dir_without_batches", "cinic10_tree_without_classes",
               "cinic10_classes_without_png", "shakespeare_dir_without_json",
               "femnist_h5_without_pixels", "femnist_h5_empty_file",
               "word_h5_empty_file", "so_lr_without_tag_count")


@pytest.mark.parametrize("case", EMPTY_CASES)
def test_empty_or_unreadable_layouts_as_the_reference(case, tmp_path):
    """Where the reference makes synthetic data the port makes the same;
    where it raises, the port raises the same exception type."""
    pytest.importorskip("h5py")
    dataset = _empty_layout(tmp_path, case)
    kw = _kw(dataset, tmp_path, so_vocab_size=64, so_tag_size=4)
    try:
        want = jax_make(JaxConfig(**kw))
    except Exception as err:   # noqa: BLE001 - the reference's refusal
        with pytest.raises(type(err)):
            torch_make(TorchConfig(**kw))
        assert case.endswith("empty_file")
        return
    got = torch_make(TorchConfig(**kw))
    assert not got.meta.get("real_data", False)
    _same(got, want)


def test_png_of_the_wrong_size_is_refused(tmp_path):
    _cinic10_tree(tmp_path, size=16)
    kw = _kw("cinic10", tmp_path)
    for make, cfg in ((torch_make, TorchConfig), (jax_make, JaxConfig)):
        with pytest.raises(ValueError, match=r"\(16, 16, 3\)"):
            make(cfg(**kw))


@pytest.mark.parametrize("dataset", ["femnist", "fed_shakespeare",
                                     "stackoverflow_lr"])
def test_h5_without_h5py_raises(dataset, tmp_path, monkeypatch):
    """A present h5 file on a host without h5py raises where the reference
    raises (``ModuleNotFoundError``), naming the file; nothing quietly
    becomes synthetic."""
    write, extra = LAYOUTS[dataset]
    write(tmp_path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    kw = _kw(dataset, tmp_path, **extra)
    with pytest.raises(ModuleNotFoundError):
        jax_make(JaxConfig(**kw))
    with pytest.raises(ModuleNotFoundError, match=r"\.h5.*needs h5py"):
        torch_make(TorchConfig(**kw))


# --------------------------------------------------------------------------
# The readers alone

def test_image_readers_bitwise_equal_reference(tmp_path):
    """Every image reader on the digits' files, and on a prefix
    (``max_samples``)."""
    pytest.importorskip("h5py")
    _digits_script().write_all(str(tmp_path))
    root = str(tmp_path)
    femnist = os.path.join(root, "FederatedEMNIST", "emnist_train.h5")
    fc100 = os.path.join(root, "fed_cifar100", "cifar100_train.h5")
    for mod_calls in (
            lambda m: m._try_load_leaf_mnist(root),
            lambda m: m._try_load_cifar_batches(root, "cifar10"),
            lambda m: m._try_load_cifar_batches(root, "cifar100"),
            lambda m: m._try_load_image_folder(root, (32, 32, 3)),
            lambda m: m._try_load_tff_h5(femnist, "pixels", (784,)),
            lambda m: m._try_load_tff_h5(femnist, "pixels", (784,), 100),
            lambda m: m._try_load_tff_h5(fc100, "image", (32, 32, 3)),
            lambda m: m._try_load_tff_h5(fc100, "label", (1,))):
        got, want = mod_calls(tproto), mod_calls(jproto)
        if want is None:
            assert got is None
            continue
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tproto._try_load_leaf_mnist(root)[0].shape == (1797, 784)


@pytest.mark.parametrize("max_len", [None, 50, 2])
def test_text_readers_bitwise_equal_reference(max_len, tmp_path):
    pytest.importorskip("h5py")
    for layout in (_fed_shakespeare_h5, _stackoverflow):
        layout(tmp_path) if layout is _fed_shakespeare_h5 \
            else layout(tmp_path, True)
    leaf = tmp_path / "leaf"
    _leaf_shakespeare(leaf)
    lim = {} if max_len is None else {"max_len": max_len}
    for call in (lambda m: m._try_load_char_corpus(str(tmp_path), 10, **lim),
                 lambda m: m._try_load_char_corpus(str(leaf), 10, **lim),
                 lambda m: m._try_load_char_corpus(str(leaf), 10 ** 6),
                 lambda m: m._try_load_word_corpus(str(tmp_path), 30, 5,
                                                   **lim)):
        got, want = call(ttext), call(jtext)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.dtype == want.dtype and np.array_equal(got, want)
    wc = str(tmp_path / "stackoverflow" / "datasets" /
             "stackoverflow.word_count")
    assert ttext.load_word_ranks(wc, 7) == jtext.load_word_ranks(wc, 7)
    assert ttext.CHAR_VOCAB == jtext.CHAR_VOCAB
    assert (ttext.PAD_ID, ttext.BOS_ID, ttext.EOS_ID, ttext.OOV_ID) == (
        jtext.PAD_ID, jtext.BOS_ID, jtext.EOS_ID, jtext.OOV_ID)
    assert ttext._MAX_CORPUS_IDS == jtext._MAX_CORPUS_IDS


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_real_text_windows_bitwise_equal_reference(noise):
    corpus = np.random.default_rng(4).integers(0, 90, 500).astype(np.int32)
    concepts = np.array([[0, 1, 2], [2, 1, 0]], np.int64)
    args = (corpus, concepts, 3, 7, 12, 90)
    got = ttext._real_text_windows(*args, np.random.default_rng(8), noise,
                                   "shakespeare")
    want = jtext._real_text_windows(*args, np.random.default_rng(8), noise,
                                    "shakespeare")
    _same(got, want)


# --------------------------------------------------------------------------
# partition.py and vertical_data.py

@pytest.mark.parametrize("n,clients,seed", [(100, 7, 0), (2000, 10, 3),
                                            (9, 9, 1)])
def test_partition_homo_bitwise_equal_reference(n, clients, seed):
    got = tpart.partition_homo(n, clients, seed)
    want = jpart.partition_homo(n, clients, seed)
    assert len(got) == len(want) == clients
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("alpha,floor,seed", [(0.5, 10, 0), (0.1, 5, 2),
                                              (100.0, 10, 1)])
def test_partition_hetero_and_counts_bitwise_equal_reference(alpha, floor,
                                                             seed):
    y = np.random.default_rng(9).integers(0, 10, 1200)
    got = tpart.partition_hetero(y, 6, alpha, floor, seed)
    want = jpart.partition_hetero(y, 6, alpha, floor, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert min(map(len, got)) >= floor
    counts = tpart.partition_counts(y, got, 10)
    assert np.array_equal(counts, jpart.partition_counts(y, want, 10))
    assert counts.sum() == len(y)


@pytest.mark.parametrize("parties", [2, 3])
@pytest.mark.parametrize("loader", ["load_nus_wide", "load_lending_club"])
def test_vertical_synthetic_bitwise_equal_reference(loader, parties):
    kw = dict(n_samples=50, num_parties=parties, seed=4)
    got = getattr(tvert, loader)(None, **kw)
    want = getattr(jvert, loader)(None, **kw)
    assert len(got[0]) == len(want[0]) == parties
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(got[1], want[1])


def test_vertical_party_synthesis_bitwise_equal_reference():
    got = tvert._synth_parties([3, 9, 4], 30, 5, 11)
    want = jvert._synth_parties([3, 9, 4], 30, 5, 11)
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a, b)
    assert np.array_equal(got[1], want[1])
    assert (tvert.NUS_WIDE_XA_DIM, tvert.NUS_WIDE_XB_DIM,
            tvert.LENDING_QUAL_DIM, tvert.LENDING_LOAN_DIM) == (
        jvert.NUS_WIDE_XA_DIM, jvert.NUS_WIDE_XB_DIM,
        jvert.LENDING_QUAL_DIM, jvert.LENDING_LOAN_DIM)


def test_lending_club_csv_bitwise_equal_reference(tmp_path):
    rng = np.random.default_rng(6)
    cols = tvert.LENDING_QUAL_DIM + tvert.LENDING_LOAN_DIM + 1
    rows = rng.normal(size=(12, cols)).round(3)
    rows[:, -1] = rng.integers(0, 2, 12)
    np.savetxt(tmp_path / "loan_processed.csv", rows, delimiter=",",
               header=",".join(f"c{i}" for i in range(cols)), comments="")
    for parties in (2, 3):
        got = tvert.load_lending_club(str(tmp_path), 10, parties)
        want = jvert.load_lending_club(str(tmp_path), 10, parties)
        for a, b in zip(got[0], want[0]):
            assert a.shape[0] == 10 and np.array_equal(a, b)
        assert got[1].dtype == want[1].dtype
        assert np.array_equal(got[1], want[1])


def test_nus_wide_files_bitwise_equal_reference(tmp_path):
    """NUS-WIDE's Groundtruth / Low_Level_Features / NUS_WID_Tags layout,
    small, read through pandas by both."""
    pytest.importorskip("pandas")
    rng = np.random.default_rng(12)
    n = 30
    lab = tmp_path / "Groundtruth" / "TrainTestLabels"
    lab.mkdir(parents=True)
    onehot = np.eye(4, dtype=int)[rng.integers(0, 4, n)]
    onehot[3] = 0                          # a row with no label: skipped
    for i, name in enumerate(("sky", "animal", "water", "person")):
        np.savetxt(lab / f"Labels_{name}_Train.txt", onehot[:, i], fmt="%d")
    feat = tmp_path / "Low_Level_Features"
    feat.mkdir()
    for name, width in (("Train_Normalized_CH.dat", 4),
                        ("Train_Normalized_EDH.dat", 3)):
        np.savetxt(feat / name, rng.random((n, width)).round(4),
                   delimiter=" ", fmt="%.4f")
    tags = tmp_path / "NUS_WID_Tags"
    tags.mkdir()
    np.savetxt(tags / "Train_Tags1k.dat", rng.integers(0, 2, (n, 5)),
               delimiter="\t", fmt="%d")
    for parties in (2, 3):
        got = tvert.load_nus_wide(str(tmp_path), 20, parties, top_k=3)
        want = jvert.load_nus_wide(str(tmp_path), 20, parties, top_k=3)
        for a, b in zip(got[0], want[0]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(got[1], want[1])


# --------------------------------------------------------------------------
# The digits, the inits and the card runs of train_readers

def test_committed_digits_are_load_digits():
    datasets = pytest.importorskip("sklearn.datasets")
    d = datasets.load_digits()
    with np.load(os.path.join(REPO, "tests", "data", "uci_digits.npz")) as f:
        images, target = f["images"], f["target"]
    assert images.dtype == target.dtype == np.uint8
    assert images.shape == (1797, 8, 8) and target.shape == (1797,)
    assert np.array_equal(images.astype(np.float64), d.images)
    assert np.array_equal(target.astype(np.int64), d.target)
    imgs, labels = _digits_script().load_digits_npz()
    assert np.array_equal(imgs, d.images / 16.0)
    assert np.array_equal(labels, d.target) and labels.dtype == np.int64


def test_digit_files_match_the_scikit_learn_scripts(tmp_path):
    """The JAX package's readers give bitwise the same arrays on the files
    of ``scripts/torch_make_digits_files.py`` as on those of
    ``make_digits_leaf.py`` / ``make_digits_formats.py`` (which need
    scikit-learn, PIL and h5py); the LEAF JSON and the pickles are the
    same bytes."""
    for mod in ("sklearn", "PIL.Image", "h5py"):
        pytest.importorskip(mod)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    out = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "torch_make_digits_files.py"), str(ours)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["skipped"] == {}
    for script in ("make_digits_leaf.py", "make_digits_formats.py"):
        out = subprocess.run([sys.executable, os.path.join(
            REPO, "scripts", script), str(theirs)], capture_output=True,
            text=True, timeout=300)
        assert out.returncode == 0, out.stderr
    leaf = os.path.join("MNIST", "train", "all_data_digits_train.json")
    assert (ours / leaf).read_bytes() == (theirs / leaf).read_bytes()
    for i in range(1, 6):
        batch = os.path.join("cifar-10-batches-py", f"data_batch_{i}")
        assert (ours / batch).read_bytes() == (theirs / batch).read_bytes()
    for read in (
            lambda d: jproto._try_load_leaf_mnist(d),
            lambda d: jproto._try_load_cifar_batches(d, "cifar10"),
            lambda d: jproto._try_load_image_folder(d, (32, 32, 3)),
            lambda d: jproto._try_load_tff_h5(os.path.join(
                d, "FederatedEMNIST", "emnist_train.h5"), "pixels", (784,)),
            lambda d: jproto._try_load_tff_h5(os.path.join(
                d, "fed_cifar100", "cifar100_train.h5"), "image",
                (32, 32, 3))):
        got, want = read(str(ours)), read(str(theirs))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_digit_files_without_h5py(tmp_path):
    """Without h5py the script writes every other layout and says it
    skipped the h5 files (the card's host has no h5py)."""
    script = os.path.join(REPO, "scripts", "torch_make_digits_files.py")
    code = ("import runpy, sys\nsys.modules['h5py'] = None\n"
            f"sys.argv = [{script!r}, sys.argv[1]]\n"
            f"runpy.run_path({script!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert sorted(report["written"]) == ["cifar", "cinic", "leaf"]
    assert report["skipped"] == {"h5": "h5py is not installed"}
    assert not (tmp_path / "FederatedEMNIST").exists()
    assert len(list((tmp_path / "cinic10" / "train").rglob("*.png"))) == 1797


@pytest.mark.parametrize("dataset,seed", [("MNIST", 1), ("MNIST", 2),
                                          ("MNIST", 0), ("cinic10", 0)])
def test_reference_init_is_the_reference_pools(dataset, seed):
    """train_readers' initial params are what the JAX package's runner puts
    in every slot of the dataset's fnn pool at ``seed`` (ModelPool.create
    with seed 42 + seed), bitwise, packed in param_specs order; cinic10's
    fnn takes cifar10's file."""
    import jax

    from feddrift_torch.models.mlp import FeedForwardNN
    from feddrift_tpu.simulation.runner import Experiment as JaxExperiment
    exp = JaxExperiment(JaxConfig(dataset=dataset, train_iterations=1,
                                  sample_num=10, seed=seed))
    shape, K = chip_smoke.READER_DATASETS[dataset][:2]
    mod = FeedForwardNN(shape, K, 10)
    want = mod.pack(params_from_jax(jax.tree_util.tree_map(
        np.asarray, exp.pool.init_params), "cpu"))
    got = np.load(chip_smoke.reader_init(dataset, seed))
    assert got.dtype == np.float32 and got.shape == (mod.num_params,)
    assert np.array_equal(got, want.numpy())
    slots = jax.tree_util.tree_map(np.asarray, exp.pool.params)
    assert np.array_equal(mod.pack(params_from_jax(slots, "cpu"))[-1].numpy(),
                          got)


def _final_accs(path):
    final, rows = {}, []
    for line in open(path):
        rec = json.loads(line)
        rows.append(rec)
        final[rec["iteration"]] = rec["Test/Acc"]
    return [final[t] for t in sorted(final)], rows


@pytest.mark.parametrize("run", chip_smoke.READER_RUNS, ids=lambda r: r[6])
def test_the_card_runs_are_pinned_and_gated(run):
    """Each fnn run of ``train_readers``: its committed series pinned as
    committed, its steps, rounds and seed those of the committed file, its
    gate series (the JAX package's CPU run where that run does not
    reproduce the committed one) a value a step, its tolerances at least
    SEA's (a clustering run's mean at least 0.03), and the K1 / K3 routes
    ``READER_DATASETS`` names those of the run's width."""
    import importlib
    k1 = importlib.import_module("feddrift_torch.kernels.local_sgd")
    dataset, seed, algo, arg, pool, T, name, pinned = run
    path = os.path.join(REPO, "runs", name, "metrics.jsonl")
    accs, rows = _final_accs(path)
    assert chip_smoke._reference_accs(path, pinned) == list(pinned) == accs
    shape, K, route, k3, _, base = chip_smoke.READER_DATASETS[dataset]
    cfg = TorchConfig(dataset=dataset, concept_drift_algo=algo,
                      concept_drift_algo_arg=arg, concept_num=pool,
                      train_iterations=T, seed=seed, **base)
    assert len(pinned) == T and pool == 4
    assert rows[-1]["round"] == T * cfg.comm_round - 1
    assert name.endswith(f"-s{seed}") and name.startswith(
        {"MNIST": "MNIST-real-fnn-", "cifar10": "cifar10-pickle-fnn-",
         "cinic10": "cinic10-png-fnn-"}[dataset] + algo)
    ref = chip_smoke.READER_REFERENCE_ACCS.get(name, pinned)
    assert len(ref) == T and all(0.0 <= a <= 1.0 for a in ref)
    step_tol, mean_tol = chip_smoke._reader_gate(name, algo)
    if algo in chip_smoke.READER_CLUSTERING:
        assert step_tol is None and mean_tol >= 0.03
    else:
        assert step_tol >= chip_smoke.STEP_ACC_TOL
        assert mean_tol >= chip_smoke.MEAN_ACC_TOL
    F = int(np.prod(shape))
    assert k1._route(F, cfg.fnn_hidden_dim, K, cfg.batch_size,
                     cfg.client_optimizer) == route
    assert (route, k3) in (("wide", "wide"), ("split", "stream"))


def test_every_committed_real_run_is_driven_or_named():
    """The committed runs on real files are train_readers' runs, but for
    the h5 ones, which the card's host cannot read (no h5py) and which
    chip_smoke names."""
    names = {r[6] for r in chip_smoke.READER_RUNS} | {
        r[0] for r in chip_smoke.READER_CONV_RUNS}
    real = {d for d in os.listdir(os.path.join(REPO, "runs"))
            if "real" in d or "-pickle-" in d or "-png-" in d or "-h5-" in d
            or d.startswith("femnist-cnn-")}
    h5 = {"femnist-h5-fnn-softcluster-H_A_C_1_10_0-s0",
          "femnist-h5-fnn-win-1-s0", "femnist-cnn-ada-win-1_iter-s0",
          "femnist-cnn-ada-win-1_iter-50c-s0"}
    assert real == names | h5 and len(names) == 13
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        source = f.read()
    assert "no h5py" in source
    assert set(chip_smoke.READER_REFERENCE_ACCS) <= names
    assert set(chip_smoke.READER_PLAIN_ENVELOPE) == {
        r[6] for r in chip_smoke.READER_RUNS}


def test_the_conv_run_is_its_committed_command_line():
    """``READER_CONV_RUNS`` is ``scripts/run_round4_cpu2.sh``'s command line
    as the CLI parses it (its ``--data_dir`` aside), pinned as committed
    and held by a sample of other seeds than the committed run's, a
    reference Test/Acc a step and seed."""
    import argparse
    import shlex

    from feddrift_torch.cli import _add_run_args, _cfg_from_args
    with open(os.path.join(REPO, "scripts", "run_round4_cpu2.sh")) as f:
        text = f.read().replace("\\\n", " ")
    line = text[text.index("-m feddrift_tpu run") + len("-m feddrift_tpu run"):]
    argv = [{"$out": "OUT"}.get(a, a) for a in shlex.split(
        line.split("&&")[0]) if a != "--flat_out_dir"]
    parser = argparse.ArgumentParser()
    _add_run_args(parser)
    cfg = _cfg_from_args(parser.parse_args(argv))
    (run, kw, pinned, path), = chip_smoke.READER_CONV_RUNS
    for k, v in kw.items():
        assert getattr(cfg, k) == v, k
    assert cfg.data_dir == "data/real_formats"
    accs, rows = _final_accs(os.path.join(REPO, "runs", run, "metrics.jsonl"))
    assert accs == list(pinned) and path == "per_round"
    seeds, ref = chip_smoke.CONV_REFERENCE_SAMPLE[run]
    assert 0 not in seeds and len(set(seeds)) == len(seeds) == len(ref) >= 8
    assert all(len(r) == len(pinned) == cfg.train_iterations for r in ref)
    assert all(0.0 <= a <= 1.0 for r in ref for a in r)
    assert chip_smoke.CONV_SAMPLE_SE_FACTOR >= 3.0


# --------------------------------------------------------------------------
# One round of the MNIST fnn on LEAF files, on the reference's draws

M, CR, TR, NR, B, S, H, K = 2, 3, 2, 40, 20, 3, 10, 10
LR, WD = 0.05, 0.001
ATOL, ADAM_PARAM_ATOL, NU_RTOL = 2e-6, 2e-5, 1e-4


def _jax_draws(key, time_w):
    """The reference's batch indices of one round, ``[M, C, S]`` each."""
    import jax
    import jax.numpy as jnp
    keys = jax.random.split(key, M * CR).reshape(M, CR, 2)

    def pair(k, w):
        w_safe = jnp.where(w.sum() > 0, w, jnp.ones_like(w))
        logits = jnp.log(w_safe + 1e-30)

        def one(kk):
            k1, k2 = jax.random.split(kk)
            return (jax.random.categorical(k1, logits),
                    jax.random.randint(k2, (), 0, NR // B))
        return jax.vmap(one)(jax.random.split(k, S))
    t_idx, slot = jax.vmap(jax.vmap(pair))(keys, jnp.asarray(time_w))
    return (torch.from_numpy(np.array(t_idx, np.int32)),
            torch.from_numpy(np.array(slot, np.int32)))


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_mnist_round_on_leaf_files_matches_reference(optimizer, tmp_path):
    """Both packages read the digits' LEAF JSON; the port's round (K1's
    plain version, then K2's) at MNIST's fnn, 784 -> 10 -> 10, against the
    reference's ``train_round`` on its own draws."""
    import jax
    import jax.numpy as jnp

    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.models.mlp import FeedForwardNN
    from feddrift_tpu.core.step import TrainStep as JStep
    from feddrift_tpu.core.step import make_optimizer
    from feddrift_tpu.models.mlp import FeedForwardNN as JFnn
    _digits_script().write_all(str(tmp_path), ("leaf",))
    kw = dict(dataset="MNIST", client_num_in_total=CR,
              client_num_per_round=CR, train_iterations=TR, sample_num=NR,
              data_dir=str(tmp_path))
    ds, jds = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    _same(ds, jds)
    assert ds.meta["real_data"] is True
    x, y = jds.x, jds.y
    tw = (np.random.default_rng(3).random((M, CR, TR + 1)) < 0.7) \
        .astype(np.float32)
    tw[:, :, TR] = 0.0
    tw[1, 2, :] = 0.0
    tw[0, 0, :TR] = 1.0
    jm = JFnn(num_classes=K, hidden_dim=H)
    keys = jax.random.split(jax.random.PRNGKey(5), M)
    jp = jax.tree_util.tree_map(np.asarray, jax.vmap(
        lambda k: jm.init(k, jnp.zeros((1, 784)))["params"])(keys))
    jstep = JStep(lambda p, xx: jm.apply({"params": p}, xx),
                  make_optimizer(optimizer, LR, WD), B, S, K)
    key = jax.random.PRNGKey(31)
    out = jstep.train_round(
        jp, jstep.init_opt_states(jp, M, CR), key, jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(tw), jnp.ones((M, CR, NR)),
        jnp.ones((M, 784)), jnp.float32(1.0), with_agg_stats=True)
    mod = FeedForwardNN((784,), K, H)
    step = TrainStep(mod, B, S, K, lr=LR, wd=WD, optimizer=optimizer,
                     device="cpu")
    params = params_from_jax(jp, "cpu")
    newp, _opt, client, n, losses, stats = step.train_round(
        params, step.init_opt_states(params, M, CR), torch.from_numpy(ds.x),
        torch.from_numpy(ds.y), torch.from_numpy(tw), 1.0,
        draws=_jax_draws(key, tw), with_agg_stats=True)
    jnewp, _, jclient, jn, jloss, jstats, _ = out
    pack = lambda t: mod.pack(params_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t), "cpu"))
    atol = ATOL if optimizer == "sgd" else ADAM_PARAM_ATOL
    np.testing.assert_allclose(mod.pack(newp), pack(jnewp), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(mod.pack(client), pack(jclient), atol=atol,
                               rtol=0)
    assert np.array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(losses, np.asarray(jloss), atol=ATOL, rtol=0)
    assert np.array_equal(stats.numpy(), np.asarray(jstats))
    assert n[1, 2] == 0

