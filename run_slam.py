#!/usr/bin/env python
"""Run the SLAM engine on a dataset (or a synthetic sequence) end-to-end.

The runnable entry point the reference never had (no main() — SURVEY.md §0).

Examples:
  python run_slam.py --synthetic --frames 60
  python run_slam.py --tum /data/rgbd_dataset_freiburg1_xyz --config configs/TUM1.yaml
  python run_slam.py --kitti /data/kitti/sequences/00 --config configs/KITTI00-02.yaml
  python run_slam.py --euroc /data/MH_01_easy
"""

from __future__ import annotations

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="ORB-SLAM style YAML settings")
    ap.add_argument("--tum", default=None, help="TUM sequence dir")
    ap.add_argument("--kitti", default=None, help="KITTI sequence dir")
    ap.add_argument("--kitti-poses", default=None, help="KITTI ground-truth poses file")
    ap.add_argument("--euroc", default=None, help="EuRoC sequence dir")
    ap.add_argument("--synthetic", action="store_true", help="synthetic rendered sequence")
    ap.add_argument("--frames", type=int, default=0, help="max frames (0 = all)")
    ap.add_argument("--traj-out", default="trajectory_tum.txt")
    ap.add_argument("--map-out", default=None, help="save map checkpoint (.npz)")
    ap.add_argument("--log", default=None, help="per-frame JSONL log path")
    ap.add_argument("--viz", default=None, help="render map+trajectory PNG here")
    ap.add_argument(
        "--async-mapping",
        action="store_true",
        help="overlap mapping epochs with tracking (slam/async_mapping.py)",
    )
    args = ap.parse_args()

    from orbslam_in_practice.utils import runtime

    runtime.setup()
    from orbslam_in_practice.config import SlamConfig, load_config
    from orbslam_in_practice.io.evaluation import ate_rmse
    from orbslam_in_practice.system import SlamSystem
    from orbslam_in_practice.utils.logging import FrameLog, StageTimer

    gt_positions = None
    gt_frame_ids = None

    if args.synthetic:
        from orbslam_in_practice.io.synthetic import SyntheticSequence

        n = args.frames or 60
        seq = SyntheticSequence(n_frames=n)
        cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=800, n_levels=4)
        frames = ((i * 0.1, seq.render(i)) for i in range(n))
        gt_positions = seq.gt_centers()
    else:
        from orbslam_in_practice.io import datasets

        if args.tum:
            ds = datasets.load_tum(args.tum)
        elif args.kitti:
            ds = datasets.load_kitti(args.kitti, args.kitti_poses)
        elif args.euroc:
            ds = datasets.load_euroc(args.euroc)
        else:
            ap.error("pick --synthetic / --tum / --kitti / --euroc")
        cfg = load_config(args.config) if args.config else SlamConfig()
        frames = ds.frames()
        gt_frame_ids, gt_positions = ds.gt_positions_for_frames()

    if args.async_mapping:
        import dataclasses

        cfg = dataclasses.replace(cfg, async_mapping=True)
    system = SlamSystem(cfg)
    timer = StageTimer()
    flog = FrameLog(args.log)
    n_done = 0
    t0 = time.perf_counter()
    for ts, img in frames:
        if args.frames and n_done >= args.frames:
            break
        with timer.stage("track"):
            pose = system.track_monocular(img, ts)
        flog.log(
            frame=n_done,
            state=system.state.name,
            tracked=pose is not None,
            inliers=system.tracker.n_inliers,
            **system.map.stats(),
        )
        n_done += 1
    system.wait_idle()  # drain queued mapping epochs inside the wall
    wall = time.perf_counter() - t0

    stats = system.map.stats()
    out = {
        "frames": n_done,
        "fps": n_done / wall,
        "state": system.state.name,
        **stats,
        "stage_ms": timer.summary(),
    }
    if gt_positions is not None:
        rmse, n_aligned, cov = ate_rmse(
            system.get_trajectory(), gt_positions, gt_frame_ids
        )
        out.update({"ate_rmse": rmse, "aligned_frames": n_aligned, "coverage": cov})
    system.save_trajectory_tum(args.traj_out)
    if args.map_out:
        system.save_map(args.map_out)
    if args.viz:
        import numpy as np

        from orbslam_in_practice.utils.viewer import render_map

        centers = [
            -(T[:3, :3].T @ T[:3, 3])
            for _, _, T in system.get_trajectory()
            if T is not None
        ]
        render_map(
            system.map,
            args.viz,
            trajectory=np.asarray(centers) if centers else None,
            title=f"{n_done} frames, {stats['n_lm']} landmarks",
        )
        out["viz"] = args.viz
    print(json.dumps(out, indent=2, default=str))


if __name__ == "__main__":
    main()
