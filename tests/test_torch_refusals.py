"""What the port does not run yet it refuses, and each refusal names the
ROADMAP item that queues it by that item's name (``ROADMAP §1 '<name>'``),
never by a number that moves as items are done. Each case triggers one
refusal, pins the item its message names, and checks that ROADMAP.md's §1
still holds an item of that name."""

import os
import re

import numpy as np
import pytest
import torch

from feddrift_torch.config import ExperimentConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _population():
    ExperimentConfig(population_size=100)


def _stream():
    ExperimentConfig(stream_data=True)


def _megastep():
    ExperimentConfig(megastep_k=4)


def _model_zoo():
    from feddrift_torch.core.step import TrainStep
    TrainStep(torch.nn.Identity(), 10, 1, 2, device="cpu")


def _mnist_files(tmp_path):
    from feddrift_torch.data.registry import make_dataset
    (tmp_path / "MNIST" / "train").mkdir(parents=True)
    make_dataset(ExperimentConfig(dataset="MNIST", data_dir=str(tmp_path),
                                  train_iterations=1, sample_num=10))


def _other_image_data():
    from feddrift_torch.data.prototype import generate_prototype_drift
    generate_prototype_drift("femnist", np.zeros((1, 10), np.int64), 1, 10,
                             5)


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
    ("other_image_data", _other_image_data, KeyError, "The other datasets"),
    ("text_corpus", _text_corpus, NotImplementedError, "The other datasets"),
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
