"""End-to-end at KITTI resolution (BASELINE.json config 3 shape:
1241x376, high feature budget, tracking + mapping).

Uses lateral-rich motion: pure forward motion at the focus of expansion is
the degenerate two-view-init case where real ORB-SLAM also waits for
parallax (verified: our initializer rejects it for the same reason —
low-parallax triangulations fail the 4-sigma^2 reprojection gate)."""

import pytest

from orbslam_in_practice.config import SlamConfig
from orbslam_in_practice.io.evaluation import ate_rmse
from orbslam_in_practice.io.synthetic import SyntheticSequence
from orbslam_in_practice.slam.tracking import TrackingState
from orbslam_in_practice.system import SlamSystem


@pytest.mark.slow
def test_e2e_kitti_resolution():
    from orbslam_in_practice.io.synthetic import make_trajectory

    seq = SyntheticSequence(
        n_frames=25,
        n_points=900,
        width=1241,
        height=376,
        fx=718.0,
        fy=718.0,
        kind="strafe",
        seed=7,
        depth_range=(5.0, 20.0),
        spread=(10.0, 4.0),
        # KITTI-scale structure: at 5-20 m the optical PSF correctly wipes
        # centimeter texture, so the scene carries building/road-scale quads
        size_range=(0.2, 1.0),
    )
    # KITTI-like baseline-to-depth ratio (~10cm steps against 5-20m depths)
    seq.poses = make_trajectory(seq.n_frames, "strafe", step=0.1)
    cfg = SlamConfig(
        fx=718.0,
        fy=718.0,
        cx=1241 / 2,
        cy=376 / 2,
        width=1241,
        height=376,
        n_features=1000,
        n_levels=4,
        fps=10.0,
        k_max=48,
        l_max=8192,
        # wide-depth low-parallax regime: a 10-KF local-BA window spans
        # enough baseline to pin down 5-20m structure (ORB-SLAM's local BA
        # similarly takes ALL first-order covisible keyframes)
        local_window=10,
    )
    sys = SlamSystem(cfg)
    n_tracked = 0
    for i in range(seq.n_frames):
        pose = sys.track_monocular(seq.render(i), i * 0.1)
        if pose is not None:
            n_tracked += 1
    assert sys.state == TrackingState.OK
    assert n_tracked > seq.n_frames // 2
    rmse, n_aligned, cov = ate_rmse(sys.get_trajectory(), seq.gt_centers())
    assert n_aligned > seq.n_frames // 2
    assert rmse < 0.08, rmse
