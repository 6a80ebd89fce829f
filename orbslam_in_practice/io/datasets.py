"""Real-dataset loaders: TUM RGB-D (mono), KITTI odometry, EuRoC MAV.

Formats per BASELINE.json configs 1-5. Images load via imageio/PIL when the
files exist; these loaders are exercised by format-level unit tests on tiny
generated fixtures (no real datasets ship in this environment).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def _load_image_gray(path: str) -> np.ndarray:
    # native decoder first (netpbm; threaded prefetch available via
    # io.native_loader.PrefetchQueue), PIL for png/jpg
    if path.endswith((".pgm", ".ppm", ".pnm")):
        from orbslam_in_practice.io import native_loader

        img = native_loader.read_image(path)
        if img is not None:
            return img
    try:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("L"), dtype=np.float32)
        return img
    except ImportError:  # pragma: no cover
        import imageio.v3 as iio

        img = iio.imread(path).astype(np.float32)
        if img.ndim == 3:
            img = img @ np.array([0.299, 0.587, 0.114], np.float32)
        return img


@dataclass
class Sequence:
    """Iterable of (timestamp, image_path); ground truth when available."""

    timestamps: np.ndarray  # (T,)
    image_paths: list
    gt_timestamps: np.ndarray | None = None  # (G,)
    gt_positions: np.ndarray | None = None  # (G, 3)
    gt_quats_xyzw: np.ndarray | None = None  # (G, 4)

    def __len__(self):
        return len(self.image_paths)

    def frames(self):
        for ts, p in zip(self.timestamps, self.image_paths):
            yield float(ts), _load_image_gray(p)

    def gt_positions_for_frames(self, max_dt: float = 0.05):
        """Associate GT to frames by nearest timestamp (TUM association)."""
        if self.gt_timestamps is None:
            return None, None
        ids, pos = [], []
        for i, ts in enumerate(self.timestamps):
            j = int(np.argmin(np.abs(self.gt_timestamps - ts)))
            if abs(self.gt_timestamps[j] - ts) <= max_dt:
                ids.append(i)
                pos.append(self.gt_positions[j])
        return np.asarray(ids), np.asarray(pos, np.float32)


def load_tum(root: str) -> Sequence:
    """TUM RGB-D: rgb.txt ('ts path') + groundtruth.txt ('ts tx ty tz qx qy qz qw')."""
    ts_list, paths = [], []
    with open(os.path.join(root, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            ts_list.append(float(ts))
            paths.append(os.path.join(root, rel))
    gt_ts, gt_pos, gt_q = None, None, None
    gt_file = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_file):
        rows = []
        with open(gt_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(x) for x in line.split()])
        arr = np.asarray(rows)
        gt_ts, gt_pos, gt_q = arr[:, 0], arr[:, 1:4], arr[:, 4:8]
    return Sequence(np.asarray(ts_list), paths, gt_ts, gt_pos, gt_q)


def load_kitti(seq_dir: str, poses_file: str | None = None) -> Sequence:
    """KITTI odometry: image_0/*.png + times.txt (+ poses/XX.txt 3x4 rows)."""
    img_dir = os.path.join(seq_dir, "image_0")
    paths = sorted(
        os.path.join(img_dir, f) for f in os.listdir(img_dir) if f.endswith(".png")
    )
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"), dtype=np.float64)
    gt_ts = gt_pos = gt_q = None
    if poses_file and os.path.exists(poses_file):
        P = np.loadtxt(poses_file).reshape(-1, 3, 4)  # Twc rows
        gt_pos = P[:, :, 3]
        gt_ts = times[: len(gt_pos)]
    return Sequence(times[: len(paths)], paths, gt_ts, gt_pos, gt_q)


def load_euroc(root: str) -> Sequence:
    """EuRoC MAV: mav0/cam0/data.csv + state_groundtruth_estimate0."""
    cam_csv = os.path.join(root, "mav0", "cam0", "data.csv")
    ts_list, paths = [], []
    with open(cam_csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts_ns, name = line.split(",")[:2]
            ts_list.append(float(ts_ns) * 1e-9)
            paths.append(os.path.join(root, "mav0", "cam0", "data", name.strip()))
    gt_csv = os.path.join(
        root, "mav0", "state_groundtruth_estimate0", "data.csv"
    )
    gt_ts = gt_pos = gt_q = None
    if os.path.exists(gt_csv):
        rows = []
        with open(gt_csv) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                vals = [float(x) for x in line.split(",")[:8]]
                rows.append(vals)
        arr = np.asarray(rows)
        gt_ts = arr[:, 0] * 1e-9
        gt_pos = arr[:, 1:4]
        gt_q = arr[:, 4:8]
    return Sequence(np.asarray(ts_list), paths, gt_ts, gt_pos, gt_q)
