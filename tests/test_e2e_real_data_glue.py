"""Real-dataset GLUE end-to-end (VERDICT r4 next #8): render a synthetic
sequence to PNG files laid out exactly like TUM RGB-D and KITTI odometry
trees, then run the REAL pipeline a user would run on mounted data —
`load_tum/load_kitti -> SlamSystem.track_monocular -> ate_rmse` — so the
first real fr1_xyz / KITTI-00 mount debugs SLAM, not glue.

No real datasets exist in this environment (verified round 4); these
fixtures exercise the identical code path: PNG decode via PIL
(`io/datasets._load_image_gray`), timestamp association
(`Sequence.gt_positions_for_frames`, TUM association rule), and the
trajectory/ATE harness. Ref: the dataset-config schema the reference reads
at /root/reference/src/Tracking.cpp:13-44.
"""

import os

import numpy as np
import pytest

from orbslam_in_practice.config import SlamConfig
from orbslam_in_practice.io import datasets
from orbslam_in_practice.io.evaluation import ate_rmse
from orbslam_in_practice.io.synthetic import SyntheticSequence
from orbslam_in_practice.system import SlamSystem

N_FRAMES = 20


def _render_pngs(tmp_path, subdir):
    """Render the suite's standard strafe scene to 8-bit PNGs."""
    from PIL import Image

    seq = SyntheticSequence(n_frames=N_FRAMES)
    img_dir = tmp_path / subdir
    img_dir.mkdir(parents=True)
    paths = []
    for i in range(N_FRAMES):
        img = np.asarray(seq.render(i))
        p = img_dir / f"{i:06d}.png"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "L").save(p)
        paths.append(p)
    return seq, paths


def _run_system(ds):
    cfg = SlamConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=800, n_levels=4
    )
    system = SlamSystem(cfg)
    n_tracked = 0
    for ts, img in ds.frames():
        pose = system.track_monocular(img, ts)
        n_tracked += pose is not None
    return system, n_tracked


def test_tum_layout_end_to_end(tmp_path):
    seq, paths = _render_pngs(tmp_path, "rgb")
    with open(tmp_path / "rgb.txt", "w") as f:
        f.write("# color images\n# file: fixture\n# timestamp filename\n")
        for i, p in enumerate(paths):
            f.write(f"{1305031102.0 + 0.1 * i:.6f} rgb/{p.name}\n")
    gt = seq.gt_centers()
    with open(tmp_path / "groundtruth.txt", "w") as f:
        f.write("# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n")
        for i, c in enumerate(gt):
            # GT sampled at a slight offset (real TUM GT is 100 Hz async);
            # association must still find every frame within max_dt
            f.write(
                f"{1305031102.0 + 0.1 * i + 0.013:.6f} "
                f"{c[0]:.6f} {c[1]:.6f} {c[2]:.6f} 0 0 0 1\n"
            )

    ds = datasets.load_tum(str(tmp_path))
    assert len(ds) == N_FRAMES
    gt_ids, gt_pos = ds.gt_positions_for_frames()
    assert len(gt_ids) == N_FRAMES  # association matched every frame

    system, n_tracked = _run_system(ds)
    assert n_tracked >= N_FRAMES - 5, f"tracked only {n_tracked}/{N_FRAMES}"
    rmse, n_aligned, _ = ate_rmse(system.get_trajectory(), gt_pos, gt_ids)
    assert n_aligned >= 10
    assert rmse < 0.10, f"ATE {rmse}"


def test_kitti_layout_end_to_end(tmp_path):
    seq_dir = tmp_path / "sequences" / "00"
    seq, paths = _render_pngs(tmp_path, "sequences/00/image_0")
    np.savetxt(seq_dir / "times.txt", 0.1 * np.arange(N_FRAMES), fmt="%.6f")
    # poses/00.txt: 3x4 Twc rows (KITTI convention)
    gt = seq.gt_centers()
    poses_file = tmp_path / "poses_00.txt"
    rows = []
    for c in gt:
        P = np.eye(4)[:3]
        P[:, 3] = c
        rows.append(P.reshape(-1))
    np.savetxt(poses_file, np.asarray(rows), fmt="%.6f")

    ds = datasets.load_kitti(str(seq_dir), str(poses_file))
    assert len(ds) == N_FRAMES
    gt_ids, gt_pos = ds.gt_positions_for_frames()

    system, n_tracked = _run_system(ds)
    assert n_tracked >= N_FRAMES - 5, f"tracked only {n_tracked}/{N_FRAMES}"
    rmse, n_aligned, _ = ate_rmse(system.get_trajectory(), gt_pos, gt_ids)
    assert n_aligned >= 10
    assert rmse < 0.10, f"ATE {rmse}"
