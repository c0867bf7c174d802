"""feddrift_torch: the PyTorch/CUDA port of feddrift_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. Module
names mirror ``feddrift_tpu`` so each counterpart is easy to find. Every
Pallas TPU kernel on a ported path becomes a hand-written CUDA kernel under
``kernels/`` with a plain PyTorch version beside it.

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain versions on the CPU. This package never
imports ``jax``, ``flax`` or ``feddrift_tpu``.
"""

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"
