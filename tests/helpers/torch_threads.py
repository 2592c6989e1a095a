"""A fixture for the tests of the PyTorch port that run many small eager
torch ops on the CPU."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one intra-op thread.  Test workers share
    the machine's cores; many small eager ops on a full thread pool each
    wait on the pool far longer than they compute.  Imported by name into
    a test module, it applies there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
