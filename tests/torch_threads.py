"""One intra-op thread for the port's CPU tests.

The suite runs its files in parallel workers (``-n 6``), and PyTorch takes
as many intra-op threads as the host has cores in each of them: the
workers' threads then contend for the same cores, and the port's many
small CPU operations pay for thread hand-offs they cannot use. A test file
imports the fixture to run its module on one thread, restored after it:

    from torch_threads import one_intra_op_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    held = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(held)
