import jax
import pytest

# CPU-only test environment: full-precision matmuls for tight tolerances.
jax.config.update("jax_default_matmul_precision", "float32")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.key(0)
