"""IO layer: config parsing, dataset format loaders on tiny fixtures, ATE."""

import numpy as np

from orbslam_in_practice.config import load_config
from orbslam_in_practice.io import datasets
from orbslam_in_practice.io.evaluation import ate_rmse


def test_load_config_orbslam_schema(tmp_path):
    p = tmp_path / "settings.yaml"
    p.write_text(
        "%YAML:1.0\n"
        "# comment\n"
        "Camera.fx: 517.3\n"
        "Camera.fy: 516.5\n"
        "Camera.cx: 318.6\n"
        "Camera.cy: 255.3\n"
        "Camera.k1: 0.26\n"
        "Camera.k2: -0.95\n"
        "Camera.p1: -0.005\n"
        "Camera.p2: 0.002\n"
        "Camera.k3: 1.16\n"
        "Camera.fps: 0\n"  # ref default: fps<=0 -> 10
        "Camera.RGB: 1\n"
        "ORBextractor.nFeatures: 1500\n"
        "ORBextractor.scaleFactor: 1.25\n"
        "ORBextractor.nLevels: 6\n"
        "ORBextractor.iniThFAST: 18\n"
        "ORBextractor.minThFAST: 5\n"
    )
    cfg = load_config(str(p))
    assert cfg.fx == 517.3 and cfg.k3 == 1.16
    assert cfg.fps == 10.0  # ref src/Tracking.cpp:31-32 default
    assert cfg.n_features == 1500 and cfg.n_levels == 6
    assert cfg.scale_factor == 1.25
    assert cfg.cam.has_distortion


def test_real_configs_parse():
    for name in ("TUM1", "KITTI00-02", "EuRoC"):
        cfg = load_config(f"configs/{name}.yaml")
        assert cfg.fx > 100 and cfg.n_features >= 1000


def _write_pgm(path, img):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.astype(np.uint8).tobytes())


def test_tum_loader(tmp_path, rng):
    d = tmp_path / "seq"
    (d / "rgb").mkdir(parents=True)
    lines = ["# comment"]
    for i in range(4):
        img = rng.integers(0, 255, (24, 32)).astype(np.uint8)
        _write_pgm(str(d / "rgb" / f"{i}.pgm"), img)
        lines.append(f"{i + 0.5:.6f} rgb/{i}.pgm")
    (d / "rgb.txt").write_text("\n".join(lines))
    (d / "groundtruth.txt").write_text(
        "# ts tx ty tz qx qy qz qw\n"
        + "\n".join(f"{i + 0.5:.6f} {i * 0.1} 0 0 0 0 0 1" for i in range(4))
    )
    seq = datasets.load_tum(str(d))
    assert len(seq) == 4
    ids, pos = seq.gt_positions_for_frames()
    assert len(ids) == 4
    assert np.allclose(pos[:, 0], [0.0, 0.1, 0.2, 0.3])
    frames = list(seq.frames())
    assert frames[0][1].shape == (24, 32)


def test_kitti_loader(tmp_path, rng):
    d = tmp_path / "00"
    (d / "image_0").mkdir(parents=True)
    for i in range(3):
        img = rng.integers(0, 255, (16, 48)).astype(np.uint8)
        _write_pgm(str(d / "image_0" / f"{i:06d}.pgm"), img)
    # loader filters .png; also write png-named copies via PIL if available
    import importlib.util

    (d / "times.txt").write_text("\n".join(f"{i * 0.1:.6f}" for i in range(3)))
    poses = tmp_path / "00.txt"
    rows = []
    for i in range(3):
        T = np.eye(4)[:3]
        T[0, 3] = i * 1.0
        rows.append(" ".join(f"{v:.6e}" for v in T.reshape(-1)))
    poses.write_text("\n".join(rows))
    if importlib.util.find_spec("PIL"):
        from PIL import Image

        for i in range(3):
            arr = rng.integers(0, 255, (16, 48)).astype(np.uint8)
            Image.fromarray(arr).save(d / "image_0" / f"{i:06d}.png")
        seq = datasets.load_kitti(str(d), str(poses))
        assert len(seq) == 3
        assert np.allclose(seq.gt_positions[:, 0], [0, 1, 2])


def test_euroc_loader(tmp_path, rng):
    d = tmp_path / "MH01"
    cam = d / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    for i in range(3):
        name = f"{1000000000 + i * 50000000}.pgm"
        img = rng.integers(0, 255, (12, 16)).astype(np.uint8)
        _write_pgm(str(cam / "data" / name), img)
        rows.append(f"{1000000000 + i * 50000000},{name}")
    (cam / "data.csv").write_text("\n".join(rows))
    gt = d / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    gt_rows = ["#ts,px,py,pz,qw,qx,qy,qz"]
    for i in range(3):
        gt_rows.append(f"{1000000000 + i * 50000000},{i * 0.2},0,0,1,0,0,0")
    (gt / "data.csv").write_text("\n".join(gt_rows))
    seq = datasets.load_euroc(str(d))
    assert len(seq) == 3
    ids, pos = seq.gt_positions_for_frames()
    assert np.allclose(pos[:, 0], [0.0, 0.2, 0.4])


def test_ate_rmse_known_alignment(rng):
    # trajectory = gt under a Sim3: perfect alignment -> ~0 RMSE
    gt = rng.normal(size=(30, 3)).astype(np.float32)
    from orbslam_in_practice.geometry import se3
    import jax.numpy as jnp

    R = np.asarray(se3.exp_so3(jnp.asarray([0.1, 0.2, 0.3], dtype=jnp.float32)))
    est_centers = 2.0 * gt @ R.T + np.array([1, 2, 3], np.float32)
    traj = []
    for i, c in enumerate(est_centers):
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, 3] = c
        traj.append((i, float(i), np.linalg.inv(Twc)))
    rmse, n, cov = ate_rmse(traj, gt)
    assert n == 30 and cov == 1.0
    assert rmse < 1e-3


def test_viewer_renders_map_and_frame(tmp_path, rng):
    """Offline viewer (MapDrawer/FrameDrawer role — absent in the reference)."""
    import jax.numpy as jnp

    from orbslam_in_practice.frontend.orb import ORBExtractor
    from orbslam_in_practice.slam.map import SlamMap
    from orbslam_in_practice.utils.viewer import render_frame, render_map

    img = jnp.asarray(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    ext = ORBExtractor(64, 1.2, 2, 20.0, 7.0)
    frame = ext(img)

    m = SlamMap(k_max=4, l_max=64, f_max=ext.total)
    obs = np.full(ext.total, -1, np.int32)
    m.add_keyframe(frame, jnp.eye(4), obs, frame_id=0)
    ids = m.allocate_landmarks(8)
    m.add_landmarks(
        ids,
        jnp.asarray(rng.normal(size=(8, 3)).astype(np.float32) + np.array([0, 0, 5.0], np.float32)),
        jnp.zeros((8, 256), jnp.int8),
        jnp.zeros((8, 3), jnp.float32),
        jnp.zeros(8, jnp.int32),
        jnp.full(8, 0.1, jnp.float32),
        jnp.full(8, 10.0, jnp.float32),
        first_kf=0,
    )
    p1 = render_map(m, str(tmp_path / "map.png"), trajectory=np.zeros((3, 3)))
    p2 = render_frame(img, frame, str(tmp_path / "frame.png"))
    import os

    assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000
