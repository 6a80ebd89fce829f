"""Distributed BA on a virtual 8-device CPU mesh (SURVEY.md §4.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam_in_practice.geometry import se3
from orbslam_in_practice.optim.ba import bundle_adjustment
from orbslam_in_practice.parallel.dist_ba import (
    dist_bundle_adjustment,
    partition_ba_problem,
)
from jax.sharding import Mesh

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], dtype=np.float32)


def make_problem(rng, n_cams=6, n_pts=256):
    pts = np.stack(
        [rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(5, 12, n_pts)],
        axis=-1,
    ).astype(np.float32)
    poses = []
    for c in range(n_cams):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(
            se3.exp_so3(jnp.asarray(rng.normal(size=3) * 0.02, dtype=jnp.float32))
        )
        T[:3, 3] = np.array([0.25 * c, 0.01 * c, 0.0])
        poses.append(T)
    poses = np.stack(poses)
    obs_cam, obs_point, obs_uv = [], [], []
    for c in range(n_cams):
        pc = pts @ poses[c][:3, :3].T + poses[c][:3, 3]
        uv = (pc[:, :2] / pc[:, 2:3]) * np.diag(K)[:2] + K[:2, 2]
        for p in range(n_pts):
            obs_cam.append(c)
            obs_point.append(p)
            obs_uv.append(uv[p])
    return (
        poses,
        pts,
        np.asarray(obs_cam, np.int32),
        np.asarray(obs_point, np.int32),
        np.asarray(obs_uv, np.float32),
    )


@pytest.fixture(scope="module")
def mesh():
    devs = np.array(jax.devices()[:8])
    assert len(devs) == 8, "conftest must provide 8 virtual devices"
    return Mesh(devs, ("d",))


def test_dist_ba_matches_single_device(rng, mesh):
    poses_true, pts, obs_cam, obs_point, obs_uv = make_problem(rng)
    n_cams = len(poses_true)
    # perturb
    poses0 = poses_true.copy()
    poses0[2:] = np.asarray(
        se3.exp_se3(jnp.asarray(rng.normal(size=(n_cams - 2, 6)) * 0.03, dtype=jnp.float32))
    ) @ poses0[2:]
    pts0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.08
    fixed = np.zeros(n_cams, bool)
    fixed[0] = fixed[1] = True

    prob = partition_ba_problem(
        poses0, pts0, obs_cam, obs_point, obs_uv,
        np.ones(len(obs_cam), np.float32), fixed, K, n_shards=8,
    )
    poses_est, pts_est = dist_bundle_adjustment(prob, mesh, iterations=15)
    poses_est = np.asarray(poses_est)
    assert np.allclose(poses_est, poses_true, atol=5e-3)
    n_pts = len(pts)
    assert np.allclose(np.asarray(pts_est)[:n_pts], pts, atol=3e-2)


def test_partitioner_preserves_problem(rng, mesh):
    """Single-shard partition == original problem semantics."""
    poses_true, pts, obs_cam, obs_point, obs_uv = make_problem(rng, n_cams=4, n_pts=64)
    fixed = np.zeros(4, bool)
    fixed[0] = fixed[1] = True
    prob = partition_ba_problem(
        poses_true, pts, obs_cam, obs_point, obs_uv,
        np.ones(len(obs_cam), np.float32), fixed, K, n_shards=8,
    )
    # already at optimum: distributed BA must not move it
    poses_est, pts_est = dist_bundle_adjustment(prob, mesh, iterations=3)
    assert np.allclose(np.asarray(poses_est), poses_true, atol=1e-4)


def test_distributed_global_ba_on_map(rng, mesh):
    """Map-level distributed BA: perturb a consistent synthetic map, run the
    sharded global BA, verify it converges back (BASELINE.json config 5)."""
    import jax.numpy as jnp

    from orbslam_in_practice.parallel.dist_ba import distributed_global_ba
    from orbslam_in_practice.slam.map import SlamMap

    n_kf, n_lm, n_feat = 6, 200, 256
    smap = SlamMap(k_max=8, l_max=512, f_max=n_feat)
    pts = np.stack(
        [rng.uniform(-4, 4, n_lm), rng.uniform(-3, 3, n_lm), rng.uniform(5, 12, n_lm)],
        axis=-1,
    ).astype(np.float32)
    poses_true = []
    for c in range(n_kf):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = np.array([0.25 * c, 0.0, 0.0])
        poses_true.append(T)

    class F:
        n_features = n_feat

        def __init__(self, xy, valid, obs):
            self.xy = jnp.asarray(xy)
            self.octave = jnp.zeros(n_feat, jnp.int32)
            self.angle = jnp.zeros(n_feat, jnp.float32)
            self.response = jnp.zeros(n_feat, jnp.float32)
            self.valid = jnp.asarray(valid)
            self.desc_pm1 = jnp.zeros((n_feat, 256), jnp.int8)

    smap.allocate_landmarks(n_lm)
    smap.lm_pos = smap.lm_pos.at[:n_lm].set(jnp.asarray(pts))
    smap.lm_valid = smap.lm_valid.at[:n_lm].set(True)
    for c in range(n_kf):
        T = poses_true[c]
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv = (pc[:, :2] / pc[:, 2:3]) * 500.0 + np.array([320.0, 240.0])
        xy = np.zeros((n_feat, 2), np.float32)
        valid = np.zeros(n_feat, bool)
        obs = np.full(n_feat, -1, np.int32)
        xy[:n_lm] = uv
        valid[:n_lm] = True
        obs[:n_lm] = np.arange(n_lm)
        smap.add_keyframe(F(xy, valid, obs), jnp.asarray(T), obs, c)

    # perturb everything except the gauge
    for c in range(2, n_kf):
        T = np.asarray(smap.kf_pose[c]).copy()
        T[:3, 3] += rng.normal(size=3).astype(np.float32) * 0.05
        smap.set_kf_poses([c], [T])
    smap.set_landmark_positions(
        np.arange(n_lm), pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05
    )

    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
    nc, nl, no = distributed_global_ba(
        smap, K, np.ones(1, np.float32), mesh, iterations=15
    )
    assert (nc, nl) == (n_kf, n_lm)
    for c in range(n_kf):
        assert np.allclose(np.asarray(smap.kf_pose[c]), poses_true[c], atol=5e-3), c
    assert np.allclose(np.asarray(smap.lm_pos[:n_lm]), pts, atol=3e-2)
