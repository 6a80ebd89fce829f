"""KITTI-shaped e2e at PRODUCTION map budgets, FULL sequence (VERDICT r3
next #2 / ADVICE r3: the r3 gate stopped at frame 100, just short of the
known tracking loss at ~122 — the gate now covers all 500 frames including
every 90-degree turn).

BASELINE.json config-3 regime: 1241x376, 2,000 features, 4 pyramid levels
(measured better than 8 at the 2k budget, tools/kitti_scale_probe.py),
forward driving with smooth 90-degree turns (corridor world with corner
structure and path clearance), sensor noise + exposure jitter, and the
PRODUCTION budgets k_max=256 / l_max=16384 (SlamConfig defaults). Slot
recycling (keyframe AND pressure-driven landmark eviction), the
covisibility vote, and keyframe culling all scale with K and L here.

Gates are set with ~2-3x headroom against what the probe
(tools/kitti_scale_probe.py) measured on this run (VERDICT r3 next #8:
margins must survive fp-scheduling differences across machines); a tracking
loss must be a short blip that relocalization recovers.

Reference intent: the per-frame pipeline surviving full sequences
(/root/reference/src/Tracking.cpp:84-155) and unbounded map growth
(/root/reference/include/Map.h:28-29) inside fixed shapes.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.kitti_scale_probe import build, run  # noqa: E402


def _common_gates(result):
    assert result["k_max"] == 256 and result["l_max"] == 16384
    # no lost segment longer than ~2 s of driving after init (the system
    # must RECOVER, not merely average well)
    long_losses = [
        seg
        for seg in result["lost_segments"]
        if seg[1] - seg[0] >= 20 and seg[0] > 10
    ]
    assert not long_losses, result["lost_segments"]
    # the K/L-scaling host paths must stay bounded at production budgets
    st = result["host_stage_ms"]
    assert st["local_map_landmarks"]["p95"] < 60.0, st
    assert st["covisibility"]["p95"] < 60.0, st
    assert st["cull_keyframes"]["p95"] < 250.0, st
    # saturation accounting: local BA must not have silently truncated
    assert result["mapper"]["n_ba_truncations"] == 0, result["mapper"]


@pytest.mark.slow
def test_e2e_kitti_turn_regime():
    """The previously-fatal window, gated in every slow-suite run: the
    FULL first 90-degree turn (frames 90-126) plus the exit onto the
    second street — built against the PRODUCTION-density 500-frame world
    (the per-run-constant density of the r3 scene made short gated tests
    denser, and easier, than the production run they stood in for).

    160 frames at ~6.7 s/frame CPU ~= 18 min; the full 500-frame pass is
    test_e2e_kitti_production_500 below (opt-in: ~1-2 h on a 2-core
    host). chip_smoke.py runs these 160 frames with the same gates on
    the GPU."""
    seq, cfg = build(500)  # production world
    from orbslam_in_practice.io.evaluation import ate_rmse
    from orbslam_in_practice.slam.tracking import TrackingState
    from orbslam_in_practice.system import SlamSystem
    import numpy as np

    system = SlamSystem(cfg)
    n = 160
    n_tracked = 0
    lost_run = cur = 0
    for i in range(n):
        pose = system.track_monocular(seq.render(i), i * 0.1)
        if pose is not None and system.state == TrackingState.OK:
            n_tracked += 1
            cur = 0
        else:
            cur += 1
            lost_run = max(lost_run, cur)
    gt = seq.gt_centers()[:n]
    rmse, n_aligned, _ = ate_rmse(system.get_trajectory(), gt)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    assert n_tracked > 0.9 * n, n_tracked
    assert lost_run < 20, lost_run
    assert 100.0 * rmse / path < 1.5, (rmse, path)
    assert system.tracker.mapper.stats()["n_ba_truncations"] == 0


@pytest.mark.slow
@pytest.mark.skipif(
    not os.environ.get("RUN_PRODUCTION_E2E"),
    reason="full 500-frame production run: ~1-2 h on a 2-core CPU host; "
    "set RUN_PRODUCTION_E2E=1",
)
def test_e2e_kitti_production_500():
    result, system = run(n_frames=500, n_features=2000, seed=3)
    _common_gates(result)
    assert result["tracked_fraction"] > 0.9, result["tracked_fraction"]
    # monocular drift without loop closure, Sim3-aligned, relative to the
    # driven path
    assert result["ate_pct_of_path"] < 1.5, result
    assert result["n_aligned"] > 450
    # the map actually grew into the production tables and recycling ran
    assert result["map"]["n_lm"] > 8000, result["map"]
    assert result["map"]["n_kf"] > 100, result["map"]


@pytest.mark.slow
@pytest.mark.skipif(
    not os.environ.get("RUN_PRODUCTION_E2E"),
    reason="production-budget loop circuit: ~1-2 h on a 2-core CPU host; "
    "set RUN_PRODUCTION_E2E=1",
)
def test_e2e_kitti_loop_production(tmp_path):
    """BASELINE config 4 at production budgets (VERDICT r4 next #3):
    the kitti_loop circuit with realistic mono drift (noise 4, jitter
    0.15); >= 1 Sim3 closure on the revisit leg, the closure reduces
    running ATE, and fuse merges stay an order below the r4 cascade
    rate. Gates mirror tools/kitti_loop_probe.py exactly."""
    import subprocess
    import sys

    out = subprocess.run(
        [
            sys.executable, "tools/kitti_loop_probe.py", "--cpu",
            "--frames", "580", "--step", "0.35",
            "--json-out", str(tmp_path / "kitti_loop.json"),
        ],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=3600 * 3,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "ALL GATES PASS" in out.stdout
