"""The deep conv models of the registry (``resnet56``, ``resnet110``,
``resnet56_gn``, ``resnet18``) against the JAX package's flax modules on the
CPU: logits and gradients on the same parameters and batch, and the init's
leaves, as ``test_torch_conv_models.py`` holds the shallow ones (its
tolerances: 1e-4 relative here). A file of their own, as their flax
references take seconds each to trace and compile."""

import math

import pytest

from test_torch_conv_models import (DEEP, _both, _jax_specs,  # noqa: F401
                                    _one_thread, check_init_leaves,
                                    check_logits_and_gradients)
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("name", DEEP)
def test_logits_and_gradients_match_flax(name):
    check_logits_and_gradients(name)


@pytest.mark.parametrize("name", DEEP)
def test_init_leaves_shapes_order_and_fan_in(name):
    check_init_leaves(name)


def test_group_norm_resnet_published_width():
    """resnet56_gn at cifar10's 32 x 32 x 3 and 10 classes: flax's count."""
    mod, jm = _both("resnet56_gn", (32, 32, 3), 10)
    assert mod.num_params == 855770
    assert sum(math.prod(s) for s in
               _jax_specs(jm, (32, 32, 3)).values()) == 855770
