"""Fixtures of the benchmark's CPU tests."""

import pytest

from h100bench_helpers import tiny_copy


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("h100bench")))


@pytest.fixture
def on_card():
    """Skips a test that needs the card where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
