"""Tests that need a CUDA device: the hand-written kernels on the card against
their plain PyTorch versions. Run from the repository root on a machine with
a card:

    python3 -m pytest tests_gpu -q

This directory imports torch and ``sdfa_tpu_torch`` only (never jax), so it
collects on a host that has no jax; the CPU tests of ``tests/`` do not
collect it. Without a card every case here skips.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")
