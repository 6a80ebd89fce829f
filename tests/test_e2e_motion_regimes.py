"""End-to-end tracking across motion regimes under sensor degradation
(VERDICT round 1 item 7: forward and rotation-dominant motion with pixel
noise and brightness jitter, plus a tightened strafe bound).

Reference behavior under test: the steady-state per-frame pipeline
(/root/reference/src/Tracking.cpp:84-155) is supposed to survive
rotation-dominant motion and imperfect imagery; the reference itself could
never demonstrate this (not runnable), so these are the capability tests.
"""

import pytest

from orbslam_in_practice.config import SlamConfig
from orbslam_in_practice.io.evaluation import ate_rmse
from orbslam_in_practice.io.synthetic import SyntheticSequence
from orbslam_in_practice.slam.tracking import TrackingState
from orbslam_in_practice.system import SlamSystem


def _config(n_features=1000):
    return SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0,
        width=640, height=480,
        n_features=n_features, n_levels=4, fps=10.0,
        k_max=64, l_max=8192,
    )


def _run(kind, n=40, noise=1.0, bj=0.1, seed=3, n_features=1000):
    seq = SyntheticSequence(
        n_frames=n, n_points=700, kind=kind, seed=seed,
        noise_sigma=noise, brightness_jitter=bj,
    )
    sys = SlamSystem(_config(n_features))
    n_tracked = 0
    for i in range(n):
        if sys.track_monocular(seq.render(i), i * 0.1) is not None:
            n_tracked += 1
    rmse, n_aligned, _ = ate_rmse(sys.get_trajectory(), seq.gt_centers())
    return sys, n_tracked, rmse, n_aligned


def test_strafe_noisy_tight_bound():
    """Lateral motion, sigma=1 pixel noise + 10% exposure jitter. The bound
    is deliberately tight (2% of the ~1.6 m trajectory) so precision
    regressions fail loudly."""
    sys, n_tracked, rmse, n_aligned = _run("strafe")
    assert sys.state == TrackingState.OK
    assert n_tracked > 30
    assert n_aligned > 30
    assert rmse < 0.02, rmse


def test_forward_motion_noisy():
    """FOE-dominant forward motion (KITTI-like) after a sideways lead-in."""
    sys, n_tracked, rmse, n_aligned = _run("forward", n=50)
    assert sys.state == TrackingState.OK
    assert n_tracked > 25
    assert rmse < 0.05, rmse


def test_rotation_dominant_noisy():
    """Yaw-dominant motion: the motion-model matcher must follow large
    image-space displacement from rotation."""
    sys, n_tracked, rmse, n_aligned = _run("rotation", n=50)
    assert sys.state == TrackingState.OK
    assert n_tracked > 25
    assert rmse < 0.05, rmse
