"""Two-view geometry against synthetic camera rigs with known R, t."""

import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.geometry import se3, twoview
from orbslam_in_practice.geometry.triangulate import triangulate_dlt

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], dtype=np.float32)


def make_rig(rng, n=100, planar=False, depth=(4.0, 8.0)):
    """Random scene + second camera with known pose; returns pixels."""
    if planar:
        pts = np.stack(
            [
                rng.uniform(-2, 2, n),
                rng.uniform(-1.5, 1.5, n),
                np.full(n, 6.0),
            ],
            axis=-1,
        )
    else:
        pts = np.stack(
            [
                rng.uniform(-2, 2, n),
                rng.uniform(-1.5, 1.5, n),
                rng.uniform(*depth, n),
            ],
            axis=-1,
        )
    w = rng.normal(size=3) * 0.05
    R = np.asarray(se3.exp_so3(jnp.asarray(w, dtype=jnp.float32)))
    t = np.array([0.4, 0.02, 0.05], dtype=np.float32)

    def proj(P, X):
        x = X @ P[:3, :3].T + P[:3, 3]
        return (x[:, :2] / x[:, 2:3]) @ np.diag(K[(0, 1), (0, 1)]) + K[:2, 2]

    P1 = np.eye(4, dtype=np.float32)
    P2 = np.eye(4, dtype=np.float32)
    P2[:3, :3] = R
    P2[:3, 3] = t
    p1 = proj(P1, pts).astype(np.float32)
    p2 = proj(P2, pts).astype(np.float32)
    return pts.astype(np.float32), R.astype(np.float32), t, p1, p2


def test_triangulate_dlt(rng):
    pts, R, t, p1, p2 = make_rig(rng, 50)
    P1 = jnp.asarray(K @ np.hstack([np.eye(3), np.zeros((3, 1))]), dtype=jnp.float32)
    P2 = jnp.asarray(K @ np.hstack([R, t[:, None]]), dtype=jnp.float32)
    X = triangulate_dlt(P1[None], P2[None], jnp.asarray(p1), jnp.asarray(p2))
    assert np.allclose(np.asarray(X), pts, atol=1e-2)


def test_eight_point_recovers_epipolar_constraint(rng):
    pts, R, t, p1, p2 = make_rig(rng, 64)
    x1n, T1 = twoview.normalize_points(jnp.asarray(p1))
    x2n, T2 = twoview.normalize_points(jnp.asarray(p2))
    Fn = twoview.eight_point(x1n, x2n)
    F = np.asarray(T2).T @ np.asarray(Fn) @ np.asarray(T1)
    F = F / np.linalg.norm(F)
    h1 = np.hstack([p1, np.ones((64, 1))])
    h2 = np.hstack([p2, np.ones((64, 1))])
    resid = np.abs(np.sum(h2 * (h1 @ F.T), axis=-1))
    assert np.max(resid) < 1e-2
    # ground-truth E residual direction check: F ~ K^-T [t]x R K^-1
    E = np.asarray(se3.hat(jnp.asarray(t))) @ R
    F_gt = np.linalg.inv(K).T @ E @ np.linalg.inv(K)
    F_gt /= np.linalg.norm(F_gt)
    align = abs(np.sum(F * F_gt))
    assert align > 0.99


def test_score_fundamental_separates_outliers(rng):
    pts, R, t, p1, p2 = make_rig(rng, 64)
    E = np.asarray(se3.hat(jnp.asarray(t))) @ R
    F = np.linalg.inv(K).T @ E @ np.linalg.inv(K)
    p2_bad = p2.copy()
    p2_bad[:10] += rng.uniform(20, 50, size=(10, 2)).astype(np.float32)
    score, inl = twoview.score_fundamental(
        jnp.asarray(F, dtype=jnp.float32),
        jnp.asarray(p1),
        jnp.asarray(p2_bad),
        jnp.ones(64, dtype=bool),
    )
    inl = np.asarray(inl)
    assert not inl[:10].any()
    assert inl[10:].all()


def test_homography_on_planar_scene(rng):
    pts, R, t, p1, p2 = make_rig(rng, 64, planar=True)
    x1n, T1 = twoview.normalize_points(jnp.asarray(p1))
    x2n, T2 = twoview.normalize_points(jnp.asarray(p2))
    Hn = twoview.homography_dlt(x1n, x2n)
    H = np.linalg.inv(np.asarray(T2)) @ np.asarray(Hn) @ np.asarray(T1)
    h1 = np.hstack([p1, np.ones((64, 1))])
    q = h1 @ H.T
    q = q[:, :2] / q[:, 2:3]
    assert np.max(np.abs(q - p2)) < 0.1
    score, inl = twoview.score_homography(
        jnp.asarray(H, dtype=jnp.float32),
        jnp.asarray(p1),
        jnp.asarray(p2),
        jnp.ones(64, dtype=bool),
    )
    assert np.asarray(inl).all()


def test_decompose_E_and_check_rt(rng):
    pts, R, t, p1, p2 = make_rig(rng, 100)
    E = np.asarray(se3.hat(jnp.asarray(t / np.linalg.norm(t)))) @ R
    Rs, ts = twoview.decompose_E(jnp.asarray(E, dtype=jnp.float32))
    mask = jnp.ones(100, dtype=bool)
    best_n, best_i = -1, -1
    for i in range(4):
        n_good, good, X, par = twoview.check_rt(
            Rs[i], ts[i], jnp.asarray(p1), jnp.asarray(p2), mask, jnp.asarray(K)
        )
        if int(n_good) > best_n:
            best_n, best_i = int(n_good), i
    assert best_n > 90
    R_best = np.asarray(Rs[best_i])
    t_best = np.asarray(ts[best_i])
    assert np.allclose(R_best, R, atol=1e-3)
    t_unit = t / np.linalg.norm(t)
    assert np.allclose(t_best, t_unit, atol=1e-3)


def test_decompose_H_recovers_pose(rng):
    pts, R, t, p1, p2 = make_rig(rng, 100, planar=True)
    # Fit H from the data, then decompose.
    x1n, T1 = twoview.normalize_points(jnp.asarray(p1))
    x2n, T2 = twoview.normalize_points(jnp.asarray(p2))
    Hn = twoview.homography_dlt(x1n, x2n)
    H = np.linalg.inv(np.asarray(T2)) @ np.asarray(Hn) @ np.asarray(T1)
    Rs, ts, ns = twoview.decompose_H(jnp.asarray(H, dtype=jnp.float32), jnp.asarray(K))
    mask = jnp.ones(100, dtype=bool)
    best_n, best_i = -1, -1
    for i in range(8):
        n_good, good, X, par = twoview.check_rt(
            Rs[i], ts[i], jnp.asarray(p1), jnp.asarray(p2), mask, jnp.asarray(K)
        )
        if int(n_good) > best_n:
            best_n, best_i = int(n_good), i
    assert best_n > 90
    assert np.allclose(np.asarray(Rs[best_i]), R, atol=5e-3)
    t_unit = t / np.linalg.norm(t)
    assert np.allclose(np.asarray(ts[best_i]), t_unit, atol=5e-3)
