"""A module fixture for the port's CPU tests: one intra-op torch thread.

The tier-1 run puts several pytest workers on the host's cores; a torch op
on tiny tensors then spins a team of threads per worker against the others
(a 2-step train run took ~100x longer than with one thread). Import it into
a test module to apply it there:

    from torch_cpu_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
