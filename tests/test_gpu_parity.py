"""The card against the plain reference (the CPU device of the same
process), at real widths: chip_smoke.py's phase 3 as tests. They need the
GPU backend beside the CPU one and skip without it:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cpu_device():
    import jax

    return jax.devices("cpu")[0]


@pytest.mark.parametrize("shape, n_features, n_levels", [((480, 640), 1000, 8), ((376, 1241), 2000, 4)])
def test_orb_and_hamming(gpu_device, cpu_device, shape, n_features, n_levels):
    from orbslam_in_practice.io.synthetic import SyntheticSequence

    h, w = shape
    seq = SyntheticSequence(n_frames=2, n_points=1500, width=w, height=h, seed=3)
    image = seq.render(1).astype(np.float32)
    chip_smoke.compare_orb(gpu_device, cpu_device, image, n_features, n_levels)


def test_pose_optimization(gpu_device, cpu_device):
    chip_smoke.compare_pose_opt(gpu_device, cpu_device)


def test_bundle_adjustment(gpu_device, cpu_device):
    chip_smoke.compare_ba(gpu_device, cpu_device)
