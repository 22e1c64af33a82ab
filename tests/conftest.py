import os
import sys

# tests see the single real CPU device; only launch/dryrun.py (run as its own
# process) forces the 512-device dry-run platform
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def rng():
    return np.random.RandomState(0)
