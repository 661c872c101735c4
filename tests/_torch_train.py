"""Shared by the training-path tests (tests/test_torch_train_*.py)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The smoke models run fastest on one torch thread (3x faster than on
    all cores here), and one thread does not oversubscribe a host that
    runs several test workers; the count before is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
