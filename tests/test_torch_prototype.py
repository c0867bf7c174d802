"""The port's prototype image data (``data/prototype.py``: MNIST-4,
femnist, cifar10, cifar100, cinic10, fed_cifar100 and their ``-smooth``
names) against the JAX package's generator on the CPU, on its synthetic
path (``tests/test_torch_readers.py`` holds the real files' readers), and
the reference inits that ``chip_smoke.py``'s ``train_images`` starts
from.

Both packages draw from numpy ``default_rng`` in the same order, so the
arrays, labels and concepts are compared bitwise: MNIST at the canonical
full size (10 clients, T1 = 11 steps of 500 rows of 784 features: 172.5
MB, about a second a generation), the other datasets at a small one.
"""

import numpy as np
import pytest

from feddrift_torch.config import ExperimentConfig as TorchConfig
from feddrift_torch.data import prototype as tproto
from feddrift_torch.data.registry import make_dataset as torch_make
from feddrift_tpu.config import ExperimentConfig as JaxConfig
from feddrift_tpu.data import prototype as jproto
from feddrift_tpu.data.registry import make_dataset as jax_make
from torch_threads import one_intra_op_thread  # noqa: F401


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


def test_smooth_ignores_real_files(tmp_path):
    """The -smooth family ignores a LEAF MNIST tree under data_dir, as the
    reference's does (``tests/test_torch_readers.py`` holds every reader
    and the other datasets' -smooth names)."""
    (tmp_path / "MNIST" / "train").mkdir(parents=True)
    kw = dict(data_dir=str(tmp_path), train_iterations=1, sample_num=20)
    got = torch_make(TorchConfig(dataset="MNIST-smooth", **kw))
    want = jax_make(JaxConfig(dataset="MNIST-smooth", **kw))
    assert np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)
    assert got.meta == want.meta == {"real_data": False,
                                     "smooth_sigma": 3.0}


OTHER_IMAGES = ("femnist", "cifar10", "cifar100", "cinic10", "fed_cifar100")


@pytest.mark.parametrize("smooth", ["", "-smooth"])
@pytest.mark.parametrize("dataset", OTHER_IMAGES)
def test_other_image_datasets_bitwise_equal_reference(dataset, smooth):
    kw = dict(dataset=dataset + smooth, seed=2, noise_prob=0.05,
              train_iterations=2, sample_num=24)
    got, want = torch_make(TorchConfig(**kw)), jax_make(JaxConfig(**kw))
    shape, classes = tproto.SPECS[dataset]
    assert got.x.shape == (10, 3, 24, *shape) and got.x.dtype == np.float32
    assert got.num_classes == classes == want.num_classes
    assert np.array_equal(got.x, want.x)
    assert np.array_equal(got.y, want.y)
    assert np.array_equal(got.concepts, want.concepts)
    assert got.meta == want.meta and got.name == want.name


def test_specs_are_the_reference_specs():
    assert tproto.SPECS == jproto.SPECS


@pytest.mark.parametrize("dataset", ["femnist", "cifar10"])
def test_image_reference_init_is_the_reference_pools(dataset):
    """train_images' initial params are what the JAX package's runner puts
    in every slot of the dataset's fnn pool at seed 0 (ModelPool.create
    with seed 42), bitwise, packed in param_specs order."""
    import jax

    import chip_smoke
    from feddrift_torch.convert import params_from_jax
    from feddrift_torch.models.mlp import FeedForwardNN
    from feddrift_tpu.simulation.runner import Experiment as JaxExperiment
    exp = JaxExperiment(JaxConfig(dataset=dataset, train_iterations=1,
                                  sample_num=10))
    shape, classes = tproto.SPECS[dataset]
    mod = FeedForwardNN(shape, classes, 10)
    want = mod.pack(params_from_jax(jax.tree_util.tree_map(
        np.asarray, exp.pool.init_params), "cpu"))
    got = np.load(chip_smoke._reference_init(dataset))
    assert got.dtype == np.float32 and got.shape == (mod.num_params,)
    assert np.array_equal(got, want.numpy())
