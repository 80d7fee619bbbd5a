import os

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA Hopper card with nvcc and triton "
        "(repro_torch kernels); skips without one")
    if os.environ.get("REPRO_ERROR_DEPRECATIONS"):
        # CI "deprecations" job: escalate DeprecationWarnings ATTRIBUTED TO
        # repro.* callers into errors.  The legacy shims warn with
        # stacklevel=2, so the warning's module is the caller's — tests may
        # exercise deprecated entry points freely, but any internal module
        # under src/repro/ calling one fails the job.
        config.addinivalue_line(
            "filterwarnings", r"error::DeprecationWarning:repro\..*")
