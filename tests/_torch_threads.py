"""One PyTorch intra-op thread per pytest-xdist worker, for the port's CPU
tests.

Under ``pytest -n N`` every worker is a process of its own, and PyTorch's CPU
kernels start one OpenMP thread per core in each of them: N processes whose
threads spin on the same cores run the full-width tests many times slower
than one thread each. On an 8-core host, six copies of
``test_torch_api_train.py`` side by side took 39-40 s each with one thread
and had not finished after 8 minutes with PyTorch's default. The
``test_torch_*`` files import this module; every worker imports every test
file while it collects, so the cap holds for the whole run. A run without
xdist keeps PyTorch's default.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
