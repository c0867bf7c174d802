"""MNIST-4, the port's prototype image data (``data/prototype.py``), against
the JAX package's generator on the CPU.

Both packages draw from numpy ``default_rng`` in the same order, so the
arrays, labels and concepts are compared bitwise, at the canonical full
size (10 clients, T1 = 11 steps of 500 rows of 784 features: 172.5 MB,
about a second a generation).
"""

import numpy as np
import pytest

from feddrift_torch.config import ExperimentConfig as TorchConfig
from feddrift_torch.data import prototype as tproto
from feddrift_torch.data.registry import available_datasets
from feddrift_torch.data.registry import make_dataset as torch_make
from feddrift_tpu.config import ExperimentConfig as JaxConfig
from feddrift_tpu.data import prototype as jproto
from feddrift_tpu.data.registry import make_dataset as jax_make


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dataset", ["MNIST", "MNIST-smooth"])
def test_dataset_bitwise_equals_reference(dataset, seed):
    kw = dict(dataset=dataset, seed=seed)
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert got.x.shape == (10, 11, 500, 784) and got.x.dtype == np.float32
    assert got.y.dtype == np.int32 and got.num_classes == 10
    assert np.array_equal(got.x, want.x)
    assert np.array_equal(got.y, want.y)
    assert np.array_equal(got.concepts, want.concepts)
    assert got.meta == want.meta and got.name == want.name


@pytest.mark.parametrize("noise_prob,time_stretch,change_points",
                         [(0.1, 1, "A"), (0.0, 2, "B"), (0.05, 1, "rand")])
def test_label_noise_stretch_and_presets_bitwise(noise_prob, time_stretch,
                                                 change_points):
    """The noise-flip draw follows each (t, c)'s sample, as the
    reference's; stretched and random change points at a small size."""
    kw = dict(dataset="MNIST", seed=3, noise_prob=noise_prob,
              time_stretch=time_stretch, change_points=change_points,
              train_iterations=4, sample_num=40)
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    assert np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)
    assert np.array_equal(got.concepts, want.concepts)


@pytest.mark.parametrize("concept", [0, 1, 2, 3, 4, 7])
def test_label_swap_matches_reference(concept):
    y = np.random.default_rng(concept).integers(0, 10, 200).astype(np.int32)
    got = tproto.apply_label_swap(y, concept, 10)
    assert np.array_equal(got, jproto.apply_label_swap(y, concept, 10))
    assert got.dtype == y.dtype
    if concept == 0:
        assert got is y


@pytest.mark.parametrize("sigma", [0.0, 1.5, 3.0])
def test_smoothing_and_prototypes_match_reference(sigma):
    rows = np.random.default_rng(1).normal(size=(4, 784))
    assert np.array_equal(tproto._smooth_rows(rows, (784,), sigma),
                          jproto._smooth_rows(rows, (784,), sigma))
    assert tproto._spatial_dims((784,)) == (28, 28)
    assert tproto._spatial_dims((10,)) is None
    got = tproto.PrototypeSampler((784,), 10, smooth_sigma=sigma)
    want = jproto.PrototypeSampler((784,), 10, smooth_sigma=sigma)
    assert np.array_equal(got.prototypes, want.prototypes)


def test_real_files_are_refused_and_smooth_ignores_them(tmp_path):
    """A LEAF MNIST tree under data_dir is refused, never silently replaced
    by synthetic data; the -smooth family ignores it, as the reference's
    does."""
    (tmp_path / "MNIST" / "train").mkdir(parents=True)
    kw = dict(data_dir=str(tmp_path), train_iterations=1, sample_num=20)
    with pytest.raises(NotImplementedError, match="real MNIST files"):
        torch_make(TorchConfig(dataset="MNIST", **kw))
    got = torch_make(TorchConfig(dataset="MNIST-smooth", **kw))
    want = jax_make(JaxConfig(dataset="MNIST-smooth", **kw))
    assert np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)


@pytest.mark.parametrize("dataset", ["femnist", "cifar10", "cifar100",
                                     "cinic10", "fed_cifar100",
                                     "femnist-smooth"])
def test_other_image_datasets_are_refused(dataset):
    assert "MNIST" in available_datasets()
    assert "MNIST-smooth" in available_datasets()
    with pytest.raises(KeyError, match="unknown dataset"):
        torch_make(TorchConfig(dataset=dataset))
    with pytest.raises(KeyError, match="not ported"):
        tproto.generate_prototype_drift(dataset.removesuffix("-smooth"),
                                        np.zeros((1, 10), np.int64), 1, 10, 5)
