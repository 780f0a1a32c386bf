"""The benchmark's own tests (python3 -m pytest benchmark/tests).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them where torch sees none; on the card they run
with `python3 -m pytest benchmark/tests -m card`."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)
