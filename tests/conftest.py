"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must
see the single real CPU device; multi-device tests spawn subprocesses with
their own flags (tests/test_sharding.py)."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def assert_close(a, b, rtol=2e-4, atol=2e-5, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)
