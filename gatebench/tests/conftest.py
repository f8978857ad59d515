"""Shared fixtures of the benchmark's own tests: a tiny mix for CPU rehearsals."""

import pytest
import torch

TINY_MIX = {"floors": 2, "places": 2, "passes": 2, "frame_dt": 6.0, "pool": 2, "scenes_seed": 7}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
