"""The benchmark's CPU tests (python -m pytest rtbench/tests -q). They run
the harness on the CPU, where the port's wrappers run their plain
versions, at small frame sizes and on one torch thread."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
