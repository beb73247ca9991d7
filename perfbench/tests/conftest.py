import os

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread_and_own_environment():
    """The suite runs several workers on a few cores: the benchmark's small
    CPU runs take one intra-op thread each, as the port's own tests do.  A
    run points the caches into the checkout through the environment; the
    tests that follow in the same worker get theirs back."""
    threads, env = torch.get_num_threads(), dict(os.environ)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    os.environ.clear()
    os.environ.update(env)
