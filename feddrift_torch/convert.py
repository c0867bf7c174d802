"""Carry a JAX (flax) parameter tree across into the port.

``params_from_jax`` takes the tree as nested dicts of numpy arrays (what
``jax.tree_util.tree_map(np.asarray, params)`` gives) and returns the
port's flat dict keyed by the flax path: ``{"block_0": {"Dense_0":
{"kernel": a}}}`` becomes ``{"block_0/Dense_0/kernel": tensor(a)}``. The
port keeps flax's layouts (Dense kernels ``[in, out]``, embeddings
``[n, E]``, conv kernels HWIO ``[kh, kw, in, out]``, a norm's ``scale``
and ``bias`` under its scope, e.g. ``ResNetFeatures_0/_Norm_0/scale`` or
``.../_Norm_0/GroupNorm_0/scale``), so no leaf is transposed. A stacked pool tree (leading
``[M]`` axis on every leaf) converts the same way; ``pool_from_jax`` turns
a whole JAX ``ModelPool`` into the port's, given the port's module.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping, device: str | torch.device = "cuda",
                    prefix: str = "") -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for name, value in tree.items():
        path = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(value, Mapping):
            out.update(params_from_jax(value, device, path))
        else:
            out[path] = torch.from_numpy(np.array(value, copy=True)).to(device)
    return out


def pool_from_jax(jax_pool, module, device: str | torch.device = "cuda"):
    """The port's ``ModelPool`` holding a JAX pool's params and its reinit
    target (``init_params``), for the port's counterpart ``module``."""
    from feddrift_torch.core.pool import ModelPool
    return ModelPool(module=module,
                     params=params_from_jax(jax_pool.params, device),
                     init_params=params_from_jax(jax_pool.init_params, device),
                     num_models=jax_pool.num_models)
