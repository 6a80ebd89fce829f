"""Long-sequence e2e: slot recycling, map plateau, live loop closure
(VERDICT round 1 items 1 + 3).

A 300-frame full orbit (camera circles and revisits its start) with pixel
noise and exposure jitter, run against a deliberately small keyframe table
(k_max=48) so the free-list/eviction machinery is genuinely exercised:
more keyframes are inserted than the table holds, yet tracking must stay
OK and the map must plateau below its fixed shapes. The same run must
close the loop live (LoopCloser.attempt fires during tracking, not in a
hand-built map). A non-revisiting sequence is the negative control: its
closure count must be ZERO (guards the mean-BRIEF place descriptor against
false positives — a false closure silently destroys the map).

Reference intent: the unbounded map of /root/reference/include/Map.h:28-29
within fixed shapes, and the loop-closure flow its Sim3Solver sketches but
never runs (/root/reference/src/Sim3Solver.cpp:7-69).
"""

import numpy as np
import pytest

from orbslam_in_practice.config import SlamConfig
from orbslam_in_practice.io.evaluation import ate_rmse
from orbslam_in_practice.io.synthetic import SyntheticSequence
from orbslam_in_practice.slam.tracking import TrackingState
from orbslam_in_practice.system import SlamSystem

K_MAX = 48
L_MAX = 4096


def _config():
    return SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0,
        width=640, height=480,
        n_features=600, n_levels=4, fps=10.0,
        k_max=K_MAX, l_max=L_MAX,
    )


@pytest.mark.slow
def test_long_orbit_recycles_and_closes_loop():
    n = 340
    seq = SyntheticSequence(
        n_frames=n, n_points=700, kind="orbit", seed=5,
        # ~1.2 turns: the revisit spans ~60 frames / a dozen keyframes, so
        # loop closure gets many chances (drift at the revisit varies
        # run-to-run with fp scheduling; a single-keyframe overlap makes
        # the closure — and the test — a coin flip)
        orbit_step=2 * np.pi / 280,
        depth_range=(3.0, 9.0), spread=(6.0, 5.0),
        noise_sigma=1.0, brightness_jitter=0.1,
    )
    sys = SlamSystem(_config())
    tr = sys.tracker
    n_tracked = 0
    ate_pre = None
    pre_snapshot = None
    for i in range(n):
        if tr.loop_closer.n_closures == 0:
            pre_snapshot = list(sys.get_trajectory())
        if sys.track_monocular(seq.render(i), i * 0.1) is not None:
            n_tracked += 1
        if tr.loop_closer.n_closures >= 1 and ate_pre is None and pre_snapshot:
            # drift accumulated over the loop, measured just before the
            # first closure fired
            ate_pre = ate_rmse(pre_snapshot, seq.gt_centers())[0]
    # tracking survived the whole loop
    assert sys.state == TrackingState.OK
    assert n_tracked > 0.9 * n, n_tracked
    # slot recycling actually exercised: more insertions than table slots,
    # while the live map plateaus inside its fixed shapes
    insertions = int(np.asarray(tr.map.kf_seq).max()) + 1
    assert insertions > K_MAX, insertions
    assert tr.map.n_kf_active() <= K_MAX
    assert tr.map.n_lm_active() < L_MAX, tr.map.n_lm_active()
    # the revisit closed the loop DURING tracking
    assert tr.loop_closer is not None and tr.loop_closer.n_closures >= 1
    gt = seq.gt_centers()
    rmse, n_aligned, _ = ate_rmse(sys.get_trajectory(), gt)
    assert n_aligned > 0.9 * n
    # the closure must REDUCE the drift accumulated over the loop (the
    # corrective effect is the capability under test; the absolute level
    # varies run-to-run with fp scheduling on this noisy 23 m circuit)
    assert ate_pre is not None
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    print(
        f"\norbit: ate_pre={ate_pre:.3f} rmse={rmse:.3f} "
        f"path={path_len:.1f} m ({100 * rmse / path_len:.2f}%)"
    )
    assert rmse < 0.6 * ate_pre, (rmse, ate_pre)
    # post-closure ATE relative to the driven path (VERDICT r2 next #9:
    # was an absolute 0.5 m ~ 2.2%)
    assert rmse < 0.01 * path_len, (rmse, path_len)


@pytest.mark.slow
def test_no_false_loop_closures_without_revisit():
    """Negative control: a non-revisiting trajectory through the SAME kind
    of repetitive-texture scene must produce zero loop closures."""
    n = 60
    seq = SyntheticSequence(
        n_frames=n, n_points=700, kind="strafe", seed=11,
        noise_sigma=1.0, brightness_jitter=0.1,
    )
    sys = SlamSystem(_config())
    for i in range(n):
        sys.track_monocular(seq.render(i), i * 0.1)
    assert sys.state == TrackingState.OK
    assert sys.tracker.loop_closer.n_closures == 0
