"""Asynchronous local mapping (slam/async_mapping.py): the keyframe epoch
runs in a worker thread overlapped with tracking — the reference's intended
producer/consumer split (include/LocalMapping.h:17-22). These tests gate
that the overlapped mode tracks with the same quality as the synchronous
one, that the queue throttles instead of growing unboundedly, and that
drain/shutdown semantics hold."""

import numpy as np
import pytest

from orbslam_in_practice.config import SlamConfig
from orbslam_in_practice.io.evaluation import ate_rmse
from orbslam_in_practice.io.synthetic import SyntheticSequence
from orbslam_in_practice.slam.tracking import TrackingState
from orbslam_in_practice.system import SlamSystem


def small_config(**kw):
    return SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0,
        width=640, height=480,
        n_features=600, n_levels=4, fps=10.0,
        k_max=64, l_max=8192,
        **kw,
    )


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=40, n_points=700, kind="strafe", seed=3)


def test_async_matches_sync_quality(seq):
    """Async mode must reach the sync path's tracking quality: same scene,
    both modes tracked >50% and ATE < 0.05 (the test_e2e gate)."""
    ates = {}
    for async_mode in (False, True):
        sys = SlamSystem(small_config(async_mapping=async_mode))
        n_tracked = 0
        for i in range(seq.n_frames):
            pose = sys.track_monocular(seq.render(i), i * 0.1)
            n_tracked += pose is not None
        assert sys.wait_idle(timeout=120.0)
        assert sys.state == TrackingState.OK
        assert n_tracked > seq.n_frames // 2, f"async={async_mode}"
        rmse, n_aligned, _ = ate_rmse(sys.get_trajectory(), seq.gt_centers())
        assert n_aligned > seq.n_frames // 2
        ates[async_mode] = rmse
        sys.shutdown()
    assert ates[True] < 0.05, f"async ATE {ates[True]} vs sync {ates[False]}"


def test_async_queue_throttles(seq):
    """The keyframe queue never exceeds QUEUE_MAX: the keyframe decision
    refuses when the worker is saturated (ORB-SLAM SetAcceptKeyFrames)."""
    sys = SlamSystem(small_config(async_mapping=True))
    drv = sys.tracker.async_driver
    assert drv is not None
    max_seen = 0
    for i in range(25):
        sys.track_monocular(seq.render(i), i * 0.1)
        max_seen = max(max_seen, drv.pending())
    assert max_seen <= drv.QUEUE_MAX
    assert sys.wait_idle(timeout=120.0)
    assert drv.pending() == 0
    sys.shutdown()


def test_async_map_settles_after_drain(seq):
    """After wait_idle, every queued epoch has been applied: the new KF has
    observations bound and the mapper ran local BA (counters visible)."""
    sys = SlamSystem(small_config(async_mapping=True))
    for i in range(25):
        sys.track_monocular(seq.render(i), i * 0.1)
    assert sys.wait_idle(timeout=120.0)
    stats = sys.map.stats()
    assert stats["n_kf"] >= 2
    assert stats["n_lm"] > 50
    # drained epochs triangulated points beyond the two-view init set
    assert stats["n_obs"] > stats["n_lm"] * 2 * 0.8
    sys.shutdown()


def test_async_reset_drains_and_restarts(seq):
    """reset() must drain the worker, then rebuild cleanly (the LOST ->
    reset-on-early-lost path runs this mid-sequence)."""
    sys = SlamSystem(small_config(async_mapping=True))
    for i in range(15):
        sys.track_monocular(seq.render(i), i * 0.1)
    sys.reset()
    assert sys.map.n_kf_active() == 0
    # re-initialize on the remaining frames
    n_tracked = 0
    for i in range(15, seq.n_frames):
        pose = sys.track_monocular(seq.render(i), i * 0.1)
        n_tracked += pose is not None
    assert sys.wait_idle(timeout=120.0)
    assert n_tracked > 5
    sys.shutdown()
