"""CPU tests of the port's benchmark; the ones marked `cuda` need a card
and skip without one (decided inside the `cuda_device` fixture)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device (skipped without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
