"""Keyframe-decision unit regressions (Tracking._need_new_keyframe).

The decision logic is a pure function of tracking/map counters, so these
tests drive it through a stub carrying exactly the state it reads —
no rendering or device work. Semantics under test: ORB-SLAM's monocular
NeedNewKeyFrame criteria (the reference left the decision absent,
/root/reference/src/Tracking.cpp:140-141) plus our guarded decay fallback.
"""

import numpy as np

from orbslam_in_practice.slam.tracking import Tracking


class _StubMap:
    def __init__(self, n_kf, ref_obs, lm_obs_count):
        self._n_kf = n_kf
        self._ref_obs = np.asarray(ref_obs)
        self.lm_obs_count = np.asarray(lm_obs_count)

    def n_kf_active(self):
        return self._n_kf

    def kf_obs_host(self):
        return self._ref_obs[None, :]  # ref_kf = 0


class _StubCfg:
    fps = 30.0


def _stub_tracking(n_inliers, peak, ref_obs, lm_obs_count, n_kf=10,
                   frames_since_kf=3):
    t = Tracking.__new__(Tracking)
    t.cfg = _StubCfg()
    t.map = _StubMap(n_kf, ref_obs, lm_obs_count)
    t.ref_kf = 0
    t.frame_id = 100
    t.last_kf_frame_id = 100 - frames_since_kf
    t.last_reloc_frame_id = -1e9
    t.n_inliers = n_inliers
    t._peak_inliers_since_kf = peak
    t.async_driver = None  # synchronous-mode decision under test
    return t


def test_decay_does_not_fire_on_mature_map():
    """ADVICE r2 regression: with ref_tracked >= n_inliers (mature map, c2's
    denominator informative) a drop below 70% of the post-KF peak must NOT
    insert a keyframe — over-insertion churns the table and was measured to
    cost accuracy on strafe/KITTI regimes."""
    # ref KF sees 100 landmarks, all with 5 observations -> ref_tracked=100
    ref_obs = np.arange(100, dtype=np.int32)
    lm_obs = np.full(100, 5, np.int32)
    # inliers 90: c2 needs < 0.9*100 = 90 -> false; decay guard:
    # ref_tracked(100) >= n_inliers(90) -> decay suppressed
    t = _stub_tracking(n_inliers=90, peak=200, ref_obs=ref_obs,
                       lm_obs_count=lm_obs)
    assert t._need_new_keyframe(None) is False


def test_decay_fires_on_young_map_with_uninformative_ref():
    """On a young map most ref-KF landmarks have only 2 observations, so
    ref_tracked collapses to ~0 and c2 can never fire; the decay criterion
    must then catch the inlier bleed before LOST."""
    ref_obs = np.arange(100, dtype=np.int32)
    lm_obs = np.full(100, 2, np.int32)  # below min_obs=3 -> ref_tracked=0
    t = _stub_tracking(n_inliers=90, peak=200, ref_obs=ref_obs,
                       lm_obs_count=lm_obs)
    assert t._need_new_keyframe(None) is True


def test_c2_governs_mature_map():
    """The plain ORB-SLAM c2 criterion still fires on a mature map when
    inliers fall under 90% of the reference-tracked count."""
    ref_obs = np.arange(100, dtype=np.int32)
    lm_obs = np.full(100, 5, np.int32)  # ref_tracked = 100
    t = _stub_tracking(n_inliers=80, peak=80, ref_obs=ref_obs,
                       lm_obs_count=lm_obs)
    assert t._need_new_keyframe(None) is True
