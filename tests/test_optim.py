"""LM/BA engine on synthetic bundle problems (SURVEY.md §4 test strategy)."""

import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.geometry import se3
from orbslam_in_practice.optim.ba import BAProblem, build_point_obs, bundle_adjustment
from orbslam_in_practice.optim.pose_opt import pose_optimization

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], dtype=np.float32)


def project_np(Tcw, X):
    pc = X @ Tcw[:3, :3].T + Tcw[:3, 3]
    return (pc[:, :2] / pc[:, 2:3]) * np.diag(K)[:2] + K[:2, 2]


def make_scene(rng, n_pts=120):
    pts = np.stack(
        [rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(4, 10, n_pts)],
        axis=-1,
    ).astype(np.float32)
    return pts


def pose_rt(rng, mag_r=0.05, mag_t=0.2):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(se3.exp_so3(jnp.asarray(rng.normal(size=3) * mag_r, dtype=jnp.float32)))
    T[:3, 3] = rng.normal(size=3) * mag_t
    return T


def test_pose_optimization_converges(rng):
    pts = make_scene(rng)
    T_true = pose_rt(rng)
    uv = project_np(T_true, pts).astype(np.float32)
    # perturb initial pose
    T0 = pose_rt(rng, 0.03, 0.1) @ T_true
    inv_s2 = np.ones(len(pts), dtype=np.float32)
    valid = np.ones(len(pts), dtype=bool)
    T_est, inliers, n_in = pose_optimization(
        jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(uv),
        jnp.asarray(inv_s2), jnp.asarray(valid), jnp.asarray(K),
    )
    assert int(n_in) == len(pts)
    assert np.allclose(np.asarray(T_est), T_true, atol=1e-3)


def test_pose_optimization_rejects_outliers(rng):
    pts = make_scene(rng)
    T_true = pose_rt(rng)
    uv = project_np(T_true, pts).astype(np.float32)
    uv[:15] += rng.uniform(15, 40, size=(15, 2)).astype(np.float32)
    T0 = pose_rt(rng, 0.02, 0.05) @ T_true
    T_est, inliers, n_in = pose_optimization(
        jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(uv),
        jnp.ones(len(pts), dtype=jnp.float32), jnp.ones(len(pts), dtype=bool),
        jnp.asarray(K),
    )
    inl = np.asarray(inliers)
    assert not inl[:15].any()
    assert inl[15:].all()
    assert np.allclose(np.asarray(T_est), T_true, atol=5e-3)


def make_ba_problem(rng, n_cams=4, n_pts=80, noise_px=0.0, o_max=8):
    pts = make_scene(rng, n_pts)
    poses_true = [np.eye(4, dtype=np.float32)]
    for c in range(1, n_cams):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(
            se3.exp_so3(jnp.asarray(rng.normal(size=3) * 0.03, dtype=jnp.float32))
        )
        T[:3, 3] = np.array([0.3 * c, 0.02 * c, 0.01 * c])
        poses_true.append(T)
    poses_true = np.stack(poses_true)
    obs_cam, obs_point, obs_uv = [], [], []
    for c in range(n_cams):
        uv = project_np(poses_true[c], pts)
        for p in range(n_pts):
            obs_cam.append(c)
            obs_point.append(p)
            obs_uv.append(uv[p] + rng.normal(size=2) * noise_px)
    obs_cam = np.asarray(obs_cam, dtype=np.int32)
    obs_point = np.asarray(obs_point, dtype=np.int32)
    obs_uv = np.asarray(obs_uv, dtype=np.float32)
    point_obs = build_point_obs(obs_point, n_pts, o_max)
    return poses_true, pts, obs_cam, obs_point, obs_uv, point_obs


def test_bundle_adjustment_converges(rng):
    poses_true, pts, obs_cam, obs_point, obs_uv, point_obs = make_ba_problem(rng)
    n_cams, n_pts = len(poses_true), len(pts)
    # perturb poses (except gauge) and points
    poses0 = poses_true.copy()
    for c in range(2, n_cams):
        poses0[c] = np.asarray(
            se3.exp_se3(jnp.asarray(np.r_[rng.normal(size=3) * 0.05, rng.normal(size=3) * 0.02],
                                    dtype=jnp.float32))
        ) @ poses0[c]
    pts0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.1
    # fix TWO cameras: with one, monocular BA has a free scale gauge
    fixed = np.zeros(n_cams, dtype=bool)
    fixed[0] = True
    fixed[1] = True
    prob = BAProblem(
        poses=jnp.asarray(poses0),
        points=jnp.asarray(pts0),
        obs_cam=jnp.asarray(obs_cam),
        obs_point=jnp.asarray(obs_point),
        obs_uv=jnp.asarray(obs_uv),
        obs_inv_sigma2=jnp.ones(len(obs_cam), dtype=jnp.float32),
        obs_mask=jnp.ones(len(obs_cam), dtype=bool),
        point_obs=jnp.asarray(point_obs),
        fixed_cam=jnp.asarray(fixed),
        K=jnp.asarray(K),
    )
    poses_est, pts_est, chi2 = bundle_adjustment(prob, iterations=25)
    # gauge camera untouched
    assert np.allclose(np.asarray(poses_est[0]), poses_true[0], atol=1e-6)
    assert np.allclose(np.asarray(poses_est), poses_true, atol=5e-3)
    assert float(jnp.mean(chi2)) < 0.1
    assert np.allclose(np.asarray(pts_est), pts, atol=2e-2)


def test_bundle_adjustment_huber_downweights_outliers(rng):
    poses_true, pts, obs_cam, obs_point, obs_uv, point_obs = make_ba_problem(rng)
    obs_uv = obs_uv.copy()
    # corrupt a handful of observations
    obs_uv[5] += 60.0
    obs_uv[37] += 45.0
    n_cams, n_pts = len(poses_true), len(pts)
    poses0 = poses_true.copy()
    poses0[2:] = np.asarray(
        se3.exp_se3(jnp.asarray(rng.normal(size=(n_cams - 2, 6)) * 0.02, dtype=jnp.float32))
    ) @ poses0[2:]
    fixed = np.zeros(n_cams, dtype=bool)
    fixed[0] = True
    fixed[1] = True
    prob = BAProblem(
        poses=jnp.asarray(poses0),
        points=jnp.asarray(pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05),
        obs_cam=jnp.asarray(obs_cam),
        obs_point=jnp.asarray(obs_point),
        obs_uv=jnp.asarray(obs_uv),
        obs_inv_sigma2=jnp.ones(len(obs_cam), dtype=jnp.float32),
        obs_mask=jnp.ones(len(obs_cam), dtype=bool),
        point_obs=jnp.asarray(point_obs),
        fixed_cam=jnp.asarray(fixed),
        K=jnp.asarray(K),
    )
    poses_est, pts_est, chi2 = bundle_adjustment(prob, iterations=25)
    # Huber downweights (not rejects) the 2 corrupted obs: small bias remains
    assert np.allclose(np.asarray(poses_est), poses_true, atol=2e-2)
    # outlier observations flagged by chi2
    chi2 = np.asarray(chi2)
    assert chi2[5] > 5.991 and chi2[37] > 5.991


def test_ba_respects_obs_mask(rng):
    poses_true, pts, obs_cam, obs_point, obs_uv, point_obs = make_ba_problem(rng)
    obs_uv = obs_uv.copy()
    mask = np.ones(len(obs_cam), dtype=bool)
    # corrupt AND mask out -> must not affect result
    obs_uv[10] += 500.0
    mask[10] = False
    n_cams = len(poses_true)
    fixed = np.zeros(n_cams, dtype=bool)
    fixed[0] = True
    prob = BAProblem(
        poses=jnp.asarray(poses_true),
        points=jnp.asarray(pts),
        obs_cam=jnp.asarray(obs_cam),
        obs_point=jnp.asarray(obs_point),
        obs_uv=jnp.asarray(obs_uv),
        obs_inv_sigma2=jnp.ones(len(obs_cam), dtype=jnp.float32),
        obs_mask=jnp.asarray(mask),
        point_obs=jnp.asarray(point_obs),
        fixed_cam=jnp.asarray(fixed),
        K=jnp.asarray(K),
    )
    poses_est, pts_est, chi2 = bundle_adjustment(prob, iterations=10)
    assert np.allclose(np.asarray(poses_est), poses_true, atol=1e-4)


def test_build_point_obs_matches_loop_reference(rng):
    """Vectorized argsort-grouping build_point_obs == the per-observation
    loop it replaced, including -1 padding, out-of-range entries, and
    per-landmark overflow."""
    n_points, o_max = 37, 4
    obs_point = rng.integers(-1, n_points + 3, size=400).astype(np.int32)

    ref = np.full((n_points, o_max), -1, dtype=np.int32)
    fill = np.zeros(n_points, dtype=np.int32)
    for o, p in enumerate(obs_point):
        if p < 0 or p >= n_points:
            continue
        k = fill[p]
        if k < o_max:
            ref[p, k] = o
            fill[p] = k + 1

    out = build_point_obs(obs_point, n_points, o_max)
    assert np.array_equal(out, ref)


def test_ba_obs_overflow_consistent(rng):
    """A landmark observed by 2x the per-landmark budget must converge to
    the same optimum as the unsaturated problem: with included_obs_mask the
    camera and landmark halves of the Schur system see the SAME observation
    subset (the truncated problem is a true GN problem on that subset), and
    the noiseless subset shares the full problem's optimum.

    Regression for the round-2 verdict: Hcc/b_c summed ALL observations
    while Hpp/b_p/W only saw the first O_max — the halves disagreed for any
    landmark with more than O_max observations."""
    from orbslam_in_practice.optim.ba import (
        adaptive_o_max,
        count_obs_drops,
        included_obs_mask,
    )

    o_budget = 12
    n_cams = 2 * o_budget  # every landmark observed by 2x the budget
    poses_true, pts, obs_cam, obs_point, obs_uv, _ = make_ba_problem(
        rng, n_cams=n_cams, n_pts=40, o_max=n_cams
    )
    # shuffle the observation order: build_point_obs keeps each landmark's
    # FIRST o_max observations, and camera-ordered observations would drop
    # cameras 12..23 wholesale (leaving them unconstrained — a property of
    # the truncation policy, not of the consistency under test)
    perm = rng.permutation(len(obs_cam))
    obs_cam, obs_point, obs_uv = obs_cam[perm], obs_point[perm], obs_uv[perm]
    poses0 = poses_true.copy()
    for c in range(2, n_cams):
        poses0[c] = np.asarray(
            se3.exp_se3(
                jnp.asarray(
                    np.r_[rng.normal(size=3) * 0.03, rng.normal(size=3) * 0.02],
                    dtype=jnp.float32,
                )
            )
        ) @ poses0[c]
    pts0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05
    fixed = np.zeros(n_cams, dtype=bool)
    fixed[:2] = True

    def solve(o_max):
        prob = BAProblem(
            poses=jnp.asarray(poses0),
            points=jnp.asarray(pts0),
            obs_cam=jnp.asarray(obs_cam),
            obs_point=jnp.asarray(obs_point),
            obs_uv=jnp.asarray(obs_uv),
            obs_inv_sigma2=jnp.ones(len(obs_cam), dtype=jnp.float32),
            obs_mask=jnp.ones(len(obs_cam), dtype=bool),
            point_obs=jnp.asarray(build_point_obs(obs_point, len(pts), o_max)),
            fixed_cam=jnp.asarray(fixed),
            K=jnp.asarray(K),
        )
        return bundle_adjustment(prob, iterations=30)

    # unsaturated: budget covers every observation
    poses_full, pts_full, _ = solve(n_cams)
    # saturated: every landmark has 2x the budget -> half its observations
    # are dropped, but CONSISTENTLY from both halves of the system
    poses_trunc, pts_trunc, _ = solve(o_budget)

    assert np.allclose(np.asarray(poses_full), poses_true, atol=5e-3)
    assert np.allclose(np.asarray(poses_trunc), poses_true, atol=5e-3)
    assert np.allclose(np.asarray(pts_trunc), pts, atol=2e-2)
    assert np.allclose(
        np.asarray(poses_trunc), np.asarray(poses_full), atol=5e-3
    )

    # drop accounting: n_pts * (n_cams - o_budget) observations over budget
    assert count_obs_drops(obs_point, len(pts), o_budget) == 40 * o_budget
    assert count_obs_drops(obs_point, len(pts), n_cams) == 0
    # the mask excludes exactly the over-budget observations
    po = build_point_obs(obs_point, len(pts), o_budget)
    inc = np.asarray(included_obs_mask(jnp.asarray(po), len(obs_cam)))
    assert int(inc.sum()) == 40 * o_budget
    # adaptive budget picks the smallest bucket covering the real max count
    assert adaptive_o_max(13, 12, cap=32) == 16
    assert adaptive_o_max(5, 12, cap=32) == 12
    assert adaptive_o_max(100, 12, cap=32) == 32


def test_schur_chunked_matches_dense():
    """The >64-camera Schur assembly (landmark-chunked matmuls, round 5 —
    replaced the (L,O,O,6,6) scatter path that OOM'd at production
    global-BA shapes) must agree with the dense one-hot path."""
    import numpy as np

    from orbslam_in_practice.optim import ba as ba_mod

    rng = np.random.default_rng(7)
    L, O, K = 37, 5, 9  # odd sizes exercise chunk padding
    T = jnp.asarray(rng.normal(size=(L, O, 6, 3)).astype(np.float32))
    Wg = jnp.asarray(rng.normal(size=(L, O, 6, 3)).astype(np.float32))
    contrib = jnp.asarray(rng.normal(size=(L, O, 6)).astype(np.float32))
    cam_g = jnp.asarray(rng.integers(0, K, (L, O)).astype(np.int32))
    pv = jnp.asarray(rng.uniform(size=(L, O)) < 0.8)

    dtype = jnp.float32
    E = ((cam_g[..., None] == jnp.arange(K)) & pv[..., None]).astype(dtype)
    A = jnp.einsum("lok,loij->lkij", E, T)
    B = jnp.einsum("lok,loij->lkij", E, Wg)
    S_dense = -jnp.einsum("lkiz,lqjz->kqij", A, B)
    b_dense = -jnp.einsum("lok,loi->ki", E, contrib)

    S_chunk, b_chunk = ba_mod.schur_offdiag_chunked(
        T, Wg, contrib, cam_g, pv, K, chunk=8
    )
    np.testing.assert_allclose(np.asarray(S_chunk), np.asarray(S_dense), atol=2e-4)
    np.testing.assert_allclose(np.asarray(b_chunk), np.asarray(b_dense), atol=2e-4)
