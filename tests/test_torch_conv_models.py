"""The port's conv models (``models/cnn.py``, ``models/resnet.py``) against
the JAX package's flax modules on the CPU.

Every registry name builds at its published widths; a small image (8 x 8 x
3, or femnist's flat 784-pixel row for the cnns) keeps the comparison
seconds long. Both packages get the same parameters (the port's init,
carried into a flax tree) and the same seeded numpy batch; the flax side
runs jitted. Tolerances, relative to the largest magnitude of the
reference's output: 1e-5 for the logits and gradients of ``cnn``,
``cnn_dropout``, ``resnet8`` and ``resnet20`` (float32 sums in other
orders, ~1e-6 measured), 1e-4 for the deeper ``resnet56``, ``resnet110``,
``resnet56_gn`` and ``resnet18`` (the rounding of 18 to 54 normalised blocks
compounds: ~1e-5 measured for ``resnet56_gn``'s gradient).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from feddrift_torch.config import ExperimentConfig
from feddrift_torch.convert import params_from_jax
from feddrift_torch.core.functional import cross_entropy
from feddrift_torch.data.drift_dataset import DriftDataset
from feddrift_torch.models import UNPORTED, create_model
from feddrift_torch.models.base import ConvNet

K, ROWS = 7, 6
SMALL_IMAGE = (8, 8, 3)
FLAT = (784,)
# resnet18 halves its side three times: at 8 x 8 its last stage would
# normalise 1 x 1 maps over the 6 rows alone, where the norm's backward
# cancels to rounding noise in both packages
WIDER_IMAGE = (16, 16, 3)
# registry name: (input shape, tolerance); the deep ones, whose reference
# takes seconds to trace and compile, are held in test_torch_conv_deep.py
MODELS = {"cnn": (FLAT, 1e-5), "cnn_dropout": (FLAT, 1e-5),
          "resnet": (SMALL_IMAGE, 1e-5), "resnet20": (SMALL_IMAGE, 1e-5),
          "resnet8": (SMALL_IMAGE, 1e-5), "resnet56": (SMALL_IMAGE, 1e-4),
          "resnet110": (SMALL_IMAGE, 1e-4),
          "resnet56_gn": (SMALL_IMAGE, 1e-4),
          "resnet18": (WIDER_IMAGE, 1e-4)}
DEEP = ("resnet56", "resnet110", "resnet56_gn", "resnet18")
SHALLOW = tuple(sorted(set(MODELS) - set(DEEP)))
# the reference compiled without LLVM's costlier passes: the deep ResNets'
# programs take most of these files' time to compile
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# the published widths: params at femnist's (28 x 28 x 1, 62 classes) and
# cifar10's (32 x 32 x 3, 10 classes) shapes, as flax counts them
# (resnet56_gn's in test_torch_conv_deep.py)
PUBLISHED = {"cnn": (FLAT, 62, 1690046),
             "cnn_dropout": (FLAT, 62, 1206590),
             "resnet8": ((32, 32, 3), 10, 78042),
             "resnet20": ((32, 32, 3), 10, 272474),
             "resnet18": ((32, 32, 3), 10, 11173962)}


def _ds(shape, classes=K):
    return DriftDataset(name="images", x=np.zeros((1, 1, 1, *shape),
                                                  np.float32),
                        y=np.zeros((1, 1, 1), np.int32),
                        concepts=np.zeros((1, 1), np.int64),
                        num_classes=classes)


@functools.cache
def _both(name, shape, classes=K):
    """The port's module and the JAX package's, for one registry name."""
    from feddrift_tpu.models import create_model as jcreate
    return (create_model(name, _ds(shape, classes), ExperimentConfig()),
            jcreate(name, _ds(shape, classes), None))


def _flax_tree(params):
    """The port's flat dict as flax's nested params tree (numpy)."""
    return unflatten_dict({tuple(k.split("/")): v.numpy()
                           for k, v in params.items()})


@functools.cache
def _jax_specs(jm, shape):
    """flax's leaves in creation order: {path: shape}, no values drawn
    (the order is read while ``init`` is traced: the tree ``eval_shape``
    returns has its keys sorted)."""
    order = []

    def init(key, x):
        params = jm.init(key, x)["params"]
        order.extend(flatten_dict(params, sep="/"))
        return params
    tree = flatten_dict(jax.eval_shape(init, jax.random.PRNGKey(0),
                                       jnp.zeros((1, *shape))), sep="/")
    return {k: tuple(tree[k].shape) for k in order}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check_logits_and_gradients(name):
    shape, tol = MODELS[name]
    mod, jm = _both(name, shape)
    assert isinstance(mod, ConvNet)
    params = mod.init_params(torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((ROWS, *shape)).astype(np.float32)
    y = rng.integers(0, K, ROWS).astype(np.int32)
    from feddrift_tpu.core.functional import cross_entropy as jce

    def reference(p):
        def loss(p):
            return jce(jm.apply({"params": p}, jnp.asarray(x)),
                       jnp.asarray(y))
        return jm.apply({"params": p}, jnp.asarray(x)), \
            jax.grad(loss)(p)
    tree = _flax_tree(params)
    jlogits, jgrad = jax.jit(reference).lower(tree).compile(
        compiler_options=FAST_COMPILE)(tree)
    flat = mod.pack(params).requires_grad_(True)
    logits = mod(mod.unpack(flat), torch.from_numpy(x))
    grad, = torch.autograd.grad(cross_entropy(logits, torch.from_numpy(y)),
                                flat)
    want = mod.pack(params_from_jax(jax.tree_util.tree_map(np.asarray, jgrad),
                                    "cpu"))
    assert logits.shape == (ROWS, K)
    assert _rel(logits.detach(), jlogits) <= tol
    assert _rel(grad, want) <= tol


@pytest.mark.parametrize("name", SHALLOW)
def test_logits_and_gradients_match_flax(name):
    check_logits_and_gradients(name)


def check_init_leaves(name):
    """The leaves in flax's creation order with flax's shapes; each kernel
    drawn at std sqrt(1 / fan_in), fan_in flax's (kh·kw·in for a conv),
    checked on the leaves large enough to estimate it (1000 values or
    more, ~2 % sampling error); norms' scales one, biases zero."""
    from jax._src.nn.initializers import _compute_fans
    shape = MODELS[name][0]
    mod, jm = _both(name, shape)
    specs = {k: s for k, (s, _) in mod.param_specs().items()}
    assert specs == _jax_specs(jm, shape)
    assert list(specs) == list(_jax_specs(jm, shape))
    params = mod.init_params(torch.Generator().manual_seed(0), "cpu")
    for k, p in params.items():
        if k.endswith("/kernel"):
            fan_in, _ = _compute_fans(tuple(p.shape))
            want = math.sqrt(1.0 / fan_in)
            assert math.prod(p.shape[:-1]) == fan_in
            if p.numel() >= 1000:
                got = float(p.std())
                assert abs(got - want) <= 0.08 * want, (k, got, want)
        elif k.endswith("/scale"):
            assert torch.equal(p, torch.ones_like(p))
        else:
            assert torch.equal(p, torch.zeros_like(p))


@pytest.mark.parametrize("name", SHALLOW)
def test_init_leaves_shapes_order_and_fan_in(name):
    check_init_leaves(name)


@pytest.mark.parametrize("name,shape,classes,count",
                         [(n, *v) for n, v in sorted(PUBLISHED.items())])
def test_published_widths(name, shape, classes, count):
    mod, _ = _both(name, shape, classes)
    assert mod.num_params == count
    assert sum(math.prod(s) for s in _jax_specs(
        _both(name, shape, classes)[1], shape).values()) == count


@pytest.mark.parametrize("name", ["cnn", "resnet8"])
def test_convert_round_trip(name):
    """A flax tree (nested numpy, as ``tree_map(np.asarray, params)``
    gives) into the port's flat dict and back, bitwise, and the pool's
    stacked ``[M, ...]`` leaves likewise; no leaf is transposed (conv
    kernels stay HWIO)."""
    shape = MODELS[name][0]
    mod, jm = _both(name, shape)
    rng = np.random.default_rng(4)
    tree = unflatten_dict({tuple(k.split("/")): rng.standard_normal(
        (3, *s)).astype(np.float32) for k, s in _jax_specs(jm, shape).items()})
    port = params_from_jax(tree, "cpu")
    assert list(port) == list(mod.param_specs())
    back = _flax_tree(port)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, tree))
    flat = mod.pack(port)
    assert flat.shape == (3, mod.num_params)
    assert all(torch.equal(a, port[k]) for k, a in mod.unpack(flat).items())


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_zoo_names_are_refused_with_their_item(name):
    from feddrift_tpu.models import available_models as javailable
    assert name in javailable()
    with pytest.raises(NotImplementedError,
                       match="ROADMAP §1 'The model zoo and transformer "
                             "training'"):
        create_model(name, _ds(SMALL_IMAGE), ExperimentConfig())


def test_unknown_name_is_a_key_error():
    with pytest.raises(KeyError):
        create_model("vgg11", _ds(SMALL_IMAGE), None)
