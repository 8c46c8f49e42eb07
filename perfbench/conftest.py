"""pytest settings of the benchmark's own tests: the ``gpu`` marker, and
the ``card`` fixture that skips where there is no CUDA card (decided when
the test runs, never at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
