import pytest


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
