import jax
import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.geometry import se3
from orbslam_in_practice.geometry.epnp import epnp
from orbslam_in_practice.geometry.sim3 import horn_sim3

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], dtype=np.float32)


def make_pnp_problem(rng, n=32):
    pts = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 10, n)],
        axis=-1,
    ).astype(np.float32)
    w = rng.normal(size=3) * 0.3
    R = np.asarray(se3.exp_so3(jnp.asarray(w, dtype=jnp.float32)))
    t = rng.normal(size=3).astype(np.float32) * 0.5
    pc = pts @ R.T + t
    # keep in front of camera
    pc[:, 2] = np.abs(pc[:, 2]) + 1.0
    # reconstruct world points consistent with pose
    pts = (pc - t) @ R
    uv = (pc[:, :2] / pc[:, 2:3]) * np.diag(K)[:2] + K[:2, 2]
    return pts.astype(np.float32), uv.astype(np.float32), R.astype(np.float32), t


def test_epnp_exact(rng):
    pw, uv, R, t = make_pnp_problem(rng, 32)
    R_est, t_est, err = epnp(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(K))
    # f32 null-space precision bounds accuracy to ~2px RMS; downstream use
    # always refines with pose_optimization (as ORB-SLAM does after PnP).
    assert float(err) < 5.0
    assert np.allclose(np.asarray(R_est), R, atol=5e-2)
    assert np.allclose(np.asarray(t_est), t, atol=0.2)


def test_epnp_masked_and_vmapped(rng):
    """RANSAC-style: vmapped over hypothesis weight masks."""
    pw, uv, R, t = make_pnp_problem(rng, 48)
    # corrupt 8 points; hypotheses sample 6 of the clean ones
    uv_bad = uv.copy()
    uv_bad[:8] += 80.0
    n_hyp = 16
    masks = np.zeros((n_hyp, 48), dtype=np.float32)
    rng2 = np.random.default_rng(1)
    for h in range(n_hyp):
        idx = rng2.choice(np.arange(8, 48), size=6, replace=False)
        masks[h, idx] = 1.0
    f = jax.vmap(lambda m: epnp(jnp.asarray(pw), jnp.asarray(uv_bad), jnp.asarray(K), w=m))
    Rs, ts, errs = f(jnp.asarray(masks))
    best = int(jnp.argmin(errs))
    assert float(errs[best]) < 1.0
    assert np.allclose(np.asarray(Rs[best]), R, atol=5e-2)


def test_horn_sim3_exact(rng):
    p1 = rng.normal(size=(30, 3)).astype(np.float32)
    w = rng.normal(size=3)
    R = np.asarray(se3.exp_so3(jnp.asarray(w, dtype=jnp.float32)))
    s_true = 2.3
    t_true = np.array([0.5, -1.0, 2.0], dtype=np.float32)
    p2 = s_true * p1 @ R.T + t_true
    s, R_est, t_est = horn_sim3(jnp.asarray(p1), jnp.asarray(p2))
    assert abs(float(s) - s_true) < 1e-3
    assert np.allclose(np.asarray(R_est), R, atol=1e-3)
    assert np.allclose(np.asarray(t_est), t_true, atol=1e-2)


def test_horn_sim3_weighted_ignores_outliers(rng):
    p1 = rng.normal(size=(30, 3)).astype(np.float32)
    R = np.asarray(se3.exp_so3(jnp.asarray(rng.normal(size=3), dtype=jnp.float32)))
    p2 = 1.5 * p1 @ R.T + np.array([1.0, 2.0, 3.0], dtype=np.float32)
    p2_bad = p2.copy()
    p2_bad[:5] += 100.0
    w = np.ones(30, dtype=np.float32)
    w[:5] = 0.0
    s, R_est, t_est = horn_sim3(jnp.asarray(p1), jnp.asarray(p2_bad), w=jnp.asarray(w))
    assert abs(float(s) - 1.5) < 1e-3
    assert np.allclose(np.asarray(R_est), R, atol=1e-3)


def test_horn_rigid(rng):
    p1 = rng.normal(size=(20, 3)).astype(np.float32)
    R = np.asarray(se3.exp_so3(jnp.asarray(rng.normal(size=3), dtype=jnp.float32)))
    t_true = np.array([0.1, 0.2, 0.3], dtype=np.float32)
    p2 = p1 @ R.T + t_true
    s, R_est, t_est = horn_sim3(jnp.asarray(p1), jnp.asarray(p2), with_scale=False)
    assert float(s) == 1.0
    assert np.allclose(np.asarray(R_est), R, atol=1e-4)
    assert np.allclose(np.asarray(t_est), t_true, atol=1e-4)
