"""KITTI-shaped long run at PRODUCTION budgets (VERDICT r2 next #2).

BASELINE.json config-3 regime: 1241x376 frames, 2,000 features, forward
driving with smooth 90-degree turns (kind="kitti" corridor world), sensor
noise + exposure jitter, k_max=256 / l_max=16384 (the SlamConfig defaults —
i.e. the production map budgets, not the 48-slot toy sizes of the recycling
e2e). Records ATE relative to path length, tracked fraction, and wall-ms of
the host-side paths that scale with K and L (`Tracking._local_map_landmarks`,
`SlamMap.covisibility`, `LocalMapper.cull_keyframes` — VERDICT r2 #2 named
exactly these three).

Reference intent: the per-frame pipeline surviving full sequences
(/root/reference/src/Tracking.cpp:84-155) and unbounded map growth
(/root/reference/include/Map.h:28-29).

Usage: python tools/kitti_scale_probe.py [--frames 500] [--cpu] [--json-out F]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(n_frames: int, n_features: int = 2000, seed: int = 3, kind: str = "kitti", step: float = 0.12, noise_sigma: float = 2.0, brightness_jitter: float = 0.08):
    """Shared by the slow test and this probe: sequence + config."""
    from orbslam_in_practice.config import SlamConfig
    from orbslam_in_practice.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(
        n_frames=n_frames,
        # CONSTANT quad density per path-meter (20 quads per 0.12 m frame
        # step ≈ 170 facade quads/m of street): with a fixed total, longer
        # runs silently get sparser streets — measured: the same code
        # tracks a dense 160-frame world through the turn (inliers 85-120)
        # but collapses on the 8-quads/frame 500-frame world (inliers
        # 111->31 over the same arc, feature matching starved of genuine
        # surface corners). Density is a property of the regime being
        # modeled, not of run length.
        n_points=20 * n_frames,
        width=1241,
        height=376,
        fx=718.0,
        fy=718.0,
        kind=kind,
        step=step,  # default ~0.12 m/frame against 5-20 m facades: KITTI-like
        seed=seed,
        depth_range=(5.0, 20.0),
        spread=(10.0, 3.0),
        size_range=(0.3, 1.2),
        noise_sigma=noise_sigma,
        brightness_jitter=brightness_jitter,  # multiplicative exposure-gain jitter
    )
    cfg = SlamConfig(
        fx=718.0,
        fy=718.0,
        cx=1241 / 2,
        cy=376 / 2,
        width=1241,
        height=376,
        n_features=n_features,
        # 4 levels, not ORB-SLAM's 8: measured head-to-head on this probe,
        # 8 levels track 0.254 of the run (turn loss, never recovers — the
        # 2k budget spreads too thin per level and the octave-gated
        # matching starves) vs 0.974 with 4 levels
        n_levels=4,
        fps=10.0,
        # k_max=256 / l_max=16384 are the defaults — production budgets
        local_window=10,
    )
    return seq, cfg


def run(n_frames: int, n_features: int = 2000, seed: int = 3, async_mapping: bool = False):
    import dataclasses

    from orbslam_in_practice.io.evaluation import ate_rmse
    from orbslam_in_practice.slam.tracking import TrackingState
    from orbslam_in_practice.system import SlamSystem

    seq, cfg = build(n_frames, n_features, seed)
    if async_mapping:
        cfg = dataclasses.replace(cfg, async_mapping=True)
    system = SlamSystem(cfg)
    tr = system.tracker

    # wall-clock the K/L-scaling host paths
    stage_ms: dict = {k: [] for k in ("local_map_landmarks", "covisibility", "cull_keyframes")}

    def wrap(obj, name, label):
        orig = getattr(obj, name)

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            stage_ms[label].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(obj, name, wrapped)

    wrap(tr, "_local_map_landmarks", "local_map_landmarks")
    wrap(system.map, "covisibility", "covisibility")
    wrap(tr.mapper, "cull_keyframes", "cull_keyframes")

    n_tracked = 0
    frame_ms = []
    ok_flags = []
    t_start = time.perf_counter()
    for i in range(n_frames):
        img = seq.render(i)
        t0 = time.perf_counter()
        pose = system.track_monocular(img, i * 0.1)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        ok = pose is not None and tr.state == TrackingState.OK
        ok_flags.append(ok)
        if ok:
            n_tracked += 1
    system.wait_idle()  # drain queued mapping epochs inside the wall
    wall = time.perf_counter() - t_start
    # contiguous un-tracked segments (where the regime is lost)
    lost_segments = []
    start = None
    for i, ok in enumerate(ok_flags):
        if not ok and start is None:
            start = i
        elif ok and start is not None:
            lost_segments.append([start, i - 1])
            start = None
    if start is not None:
        lost_segments.append([start, n_frames - 1])

    gt = seq.gt_centers()
    rmse, n_aligned, _ = ate_rmse(system.get_trajectory(), gt)
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    stats = system.map.stats()
    result = {
        "frames": n_frames,
        "async_mapping": async_mapping,
        "n_features": n_features,
        "resolution": [1241, 376],
        "k_max": cfg.k_max,
        "l_max": cfg.l_max,
        "tracked_fraction": n_tracked / n_frames,
        "ate_rmse": float(rmse),
        "path_length_m": path_len,
        "ate_pct_of_path": 100.0 * float(rmse) / path_len,
        "n_aligned": int(n_aligned),
        "fps_slam_only": n_frames / (sum(frame_ms) / 1e3),
        "wall_s_incl_render": wall,
        "map": {k: v for k, v in stats.items() if np.isscalar(v)},
        # saturation counters (VERDICT r3 weak #3: every run artifact must
        # report whether local BA clipped anything)
        "mapper": tr.mapper.stats(),
        "n_local_map_truncations": tr.n_local_map_truncations,
        "n_loop_closures": (
            tr.loop_closer.n_closures if tr.loop_closer is not None else 0
        ),
        "lost_segments": lost_segments,
        "host_stage_ms": {
            k: {
                "mean": float(np.mean(v)) if v else 0.0,
                "p95": float(np.percentile(v, 95)) if v else 0.0,
                "max": float(np.max(v)) if v else 0.0,
                "calls": len(v),
            }
            for k, v in stage_ms.items()
        },
    }
    return result, system


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--async-mapping", action="store_true")
    args = ap.parse_args()

    from orbslam_in_practice.utils import runtime

    runtime.setup(cpu=args.cpu)

    result, _ = run(args.frames, args.features, async_mapping=args.async_mapping)
    print(json.dumps(result, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    sys.exit(main())
