"""Tests of the benchmark's harness: `python -m pytest portbench/tests` from
the repo's root.  On the CPU they drive the harness at small sizes through
the port's plain versions; a test marked `card` needs a CUDA card and skips
without one."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


# The sizes of a read set that a CPU test holds.
SMALL_READS = {"genome_bp": 3000, "depth": 30, "read_length": 101}
