"""Test configuration: CPU with a virtual 8-device mesh by default.

Must run before jax initializes a backend (SURVEY.md §4: simulated
multi-host meshes let distributed BA be tested single-machine; collectives
run identically on the simulated mesh).

Tests marked ``gpu`` compare the card with the CPU reference in one
process; they need the GPU backend enabled beside the CPU one:
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``. Without a GPU
they skip inside the ``gpu_device`` fixture.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from orbslam_in_practice.utils import runtime  # noqa: E402

runtime.setup(cpu=os.environ["JAX_PLATFORMS"] == "cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when the process has none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU backend in this process (run with JAX_PLATFORMS=cuda,cpu)")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running e2e tests")
    config.addinivalue_line("markers", "gpu: compares the GPU with the CPU reference")
