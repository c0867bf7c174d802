"""Hand-written CUDA kernels of the port, each beside its plain version."""

from feddrift_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_ref)
from feddrift_torch.kernels.local_sgd import (  # noqa: F401
    local_sgd, local_sgd_ref)
