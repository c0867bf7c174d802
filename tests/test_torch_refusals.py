"""What the port does not run yet it refuses, and each refusal names the
ROADMAP item that queues it by that item's name (``ROADMAP §1 '<name>'``),
never by a number that moves as items are done. Each case triggers one
refusal, pins the item its message names, and checks that ROADMAP.md's §1
still holds an item of that name."""

import os
import re

import numpy as np
import pytest

from feddrift_torch.config import ExperimentConfig
from torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _population():
    ExperimentConfig(population_size=100)


def _stream():
    ExperimentConfig(stream_data=True)


def _megastep():
    ExperimentConfig(megastep_k=4)


def _model_zoo():
    from feddrift_torch.data.registry import make_dataset
    from feddrift_torch.models import create_model
    create_model("mobilenet", make_dataset(ExperimentConfig(sample_num=10)),
                 ExperimentConfig())


def _mnist_files(tmp_path):
    from feddrift_torch.data.registry import make_dataset
    (tmp_path / "MNIST" / "train").mkdir(parents=True)
    make_dataset(ExperimentConfig(dataset="MNIST", data_dir=str(tmp_path),
                                  train_iterations=1, sample_num=10))


def _other_image_data(tmp_path):
    from feddrift_torch.data.prototype import generate_prototype_drift
    (tmp_path / "cifar-10-batches-py").mkdir()
    generate_prototype_drift("cifar10", np.zeros((1, 10), np.int64), 1, 10,
                             5, data_dir=str(tmp_path))


def _word_corpus(tmp_path):
    from feddrift_torch.data.registry import make_dataset
    base = tmp_path / "stackoverflow" / "datasets"
    base.mkdir(parents=True)
    (base / "stackoverflow_train.h5").write_bytes(b"")
    make_dataset(ExperimentConfig(dataset="stackoverflow_nwp", sample_num=1,
                                  data_dir=str(tmp_path)))


def _text_corpus(tmp_path):
    from feddrift_torch.data.registry import make_dataset
    (tmp_path / "shakespeare" / "train").mkdir(parents=True)
    make_dataset(ExperimentConfig(dataset="shakespeare", sample_num=1,
                                  data_dir=str(tmp_path)))


# (case, the call, the exception, the ROADMAP §1 item it names)
REFUSALS = (
    ("population", _population, NotImplementedError,
     "In-round robustness, population and streaming"),
    ("stream_data", _stream, NotImplementedError,
     "In-round robustness, population and streaming"),
    ("megastep", _megastep, NotImplementedError, "Megastep"),
    ("model_zoo", _model_zoo, NotImplementedError,
     "The model zoo and transformer training"),
    ("mnist_files", _mnist_files, NotImplementedError, "The other datasets"),
    ("other_image_data", _other_image_data, NotImplementedError,
     "The other datasets"),
    ("text_corpus", _text_corpus, NotImplementedError, "The other datasets"),
    ("word_corpus", _word_corpus, NotImplementedError, "The other datasets"),
)


@pytest.mark.parametrize("case,call,exc,item", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_refusal_names_its_roadmap_item(case, call, exc, item, tmp_path):
    with pytest.raises(exc) as got:
        call(tmp_path) if "tmp_path" in call.__code__.co_varnames else call()
    message = str(got.value)
    assert f"ROADMAP §1 '{item}'" in message, message
    assert not re.search(r"ROADMAP items? \d", message), message
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read().replace("`", "")
    assert re.search(r"^\s*\d+\. \*\*" + re.escape(item) + r"\.?\*\*",
                     roadmap, re.M), f"ROADMAP §1 has no item {item!r}"


def test_no_refusal_cites_an_item_number():
    """No message or docstring of the port points at a ROADMAP item by
    number."""
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "feddrift_torch")):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, name)) as f:
                    for i, line in enumerate(f, 1):
                        if re.search(r"ROADMAP (§\d+ )?items? \d", line):
                            hits.append(f"{name}:{i}")
    assert hits == []


# the shapes no K1 layout takes on the card (ROADMAP §2's item below):
# (case, F, H, K, B, optimizer); H = 0 is the lr
UNLAID = (("fmow_lr_adam", 3072, 0, 62, 500, "adam"),
          ("fmow_lr_sgd", 3072, 0, 62, 500, "sgd"),
          ("cifar100_fnn_adam", 3072, 10, 100, 500, "adam"),
          ("cifar100_fnn_sgd", 3072, 10, 100, 500, "sgd"),
          ("femnist_lr_adam", 784, 0, 62, 500, "adam"),
          ("cifar10_lr_sgd", 3072, 0, 10, 500, "sgd"),
          ("stackoverflow_lr_full_scale_fnn", 10000, 10, 500, 500, "adam"))
LAYOUT_ITEM = "K1 and K3 at wide inputs: what PRs 12, 14 and 15 left"


@pytest.mark.parametrize("case,F,H,K,B,opt", UNLAID,
                         ids=[u[0] for u in UNLAID])
def test_unlaid_k1_shapes_are_refused_naming_the_item(case, F, H, K, B,
                                                      opt):
    """``TrainStep.create`` refuses these on the card before the run puts
    its data there; the route function says why, naming ROADMAP §2's item
    by its name, and the CPU's plain version still takes the shape."""
    from feddrift_torch.core.step import TrainStep
    from feddrift_torch.kernels.local_sgd import (MAX_SMEM,
                                                  general_smem_bytes,
                                                  layout_refusal)
    from feddrift_torch.models.mlp import FeedForwardNN, LogisticRegression
    message = layout_refusal(F, H, K, B, opt)
    model = f"the fnn {F} -> {H} -> {K}" if H else f"the lr {F} -> {K}"
    assert message == (
        f"{model} at batch {B} under {opt!r}: no K1 layout takes it on the "
        f"card (the fused, wide and split kernels refuse the shape, and the "
        f"general kernel needs {general_smem_bytes(F, H, K, B, opt)} bytes "
        f"of shared memory a block, above {MAX_SMEM}); ROADMAP §2 "
        f"'{LAYOUT_ITEM}' (shapes no layout takes yet)")
    assert not re.search(r"ROADMAP items? \d", message)
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read().replace("`", "")
    assert re.search(r"^\s*\d+\. \*\*" + re.escape(LAYOUT_ITEM) + r"\.?\*\*",
                     roadmap, re.M)
    mod = FeedForwardNN((F,), K, H) if H else LogisticRegression((F,), K)
    cfg = ExperimentConfig(batch_size=B, sample_num=B, client_optimizer=opt)
    assert TrainStep.create(cfg, mod, K, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("shape", [(3, 10, 2, 500, "adam"),
                                   (784, 10, 10, 500, "adam"),
                                   (3072, 10, 62, 500, "sgd"),
                                   (3, 0, 2, 500, "adam"),
                                   (1000, 10, 50, 500, "sgd"),
                                   (1000, 10, 50, 500, "adam"),
                                   (18, 10, 2, 500, "adam"),
                                   (5, 10, 2, 500, "adam"),
                                   (784, 10, 62, 500, "adam"),
                                   (3072, 10, 10, 500, "adam")])
def test_laid_k1_shapes_are_not_refused(shape):
    """Shapes a K1 layout takes (SEA's fnn, MNIST-4's, fmow's under SGD,
    SEA's lr, stackoverflow_lr's fnn under SGD on the wide kernel and under
    AMSGrad on the split kernel padded past F, susy's and ro's on the
    general kernel, femnist's and cifar10's)."""
    from feddrift_torch.kernels.local_sgd import layout_refusal
    assert layout_refusal(*shape) is None
