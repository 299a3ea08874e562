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


@pytest.fixture
def caustics_config():
    """configs/demo.py loaded as a module of its own with caustics on (the
    photon budget gives the demo scene 16,384 photons): a configuration
    local to the tests, in no cell."""
    from rtbench.core import spec

    mod = spec.load_module(os.path.join(ROOT, "rtbench", "configs", "demo.py"),
                           "test_config_demo_caustics")
    mod.OVERRIDES = {"enable_caustics": True}
    return mod
