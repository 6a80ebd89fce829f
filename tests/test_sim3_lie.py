import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.geometry import sim3_lie


def test_exp_log_sim3_roundtrip(rng):
    xi = jnp.asarray(rng.normal(size=(32, 7)) * 0.5, dtype=jnp.float32)
    G = sim3_lie.exp_sim3(xi)
    xi2 = sim3_lie.log_sim3(G)
    assert np.allclose(np.asarray(xi), np.asarray(xi2), atol=5e-3)


def test_exp_sim3_zero_is_identity():
    G = sim3_lie.exp_sim3(jnp.zeros(7, dtype=jnp.float32))
    assert np.allclose(np.asarray(G), np.eye(4), atol=1e-6)


def test_calc_W_matches_numeric_integral(rng):
    # W = int_0^1 e^(sigma u) e^(hat(phi) u) du, checked by quadrature
    from orbslam_in_practice.geometry.se3 import exp_so3

    for _ in range(5):
        phi = rng.normal(size=3) * 0.8
        sigma = rng.normal() * 0.5
        us = np.linspace(0, 1, 2001)
        Rs = np.asarray(
            exp_so3(jnp.asarray(phi[None, :] * us[:, None], dtype=jnp.float32))
        )  # (U, 3, 3) batched
        acc = np.mean(np.exp(sigma * us)[:, None, None] * Rs, axis=0)
        W = np.asarray(
            sim3_lie._calc_W(jnp.asarray(phi, dtype=jnp.float32), jnp.asarray(sigma, dtype=jnp.float32))
        )
        assert np.allclose(W, acc, atol=2e-3)


def test_sim3_inverse(rng):
    xi = jnp.asarray(rng.normal(size=7) * 0.5, dtype=jnp.float32)
    G = sim3_lie.exp_sim3(xi)
    I = G @ sim3_lie.sim3_inverse(G)
    # f32 exp_so3 orthonormality bounds this at ~2e-3
    assert np.allclose(np.asarray(I), np.eye(4), atol=5e-3)


def test_pose_graph_closes_loop(rng):
    """Chain of poses with drift; a loop edge pulls the chain closed."""
    from orbslam_in_practice.optim.pose_graph import optimize_pose_graph

    n = 10
    # ground truth: poses on a line
    true_xi = np.zeros((n, 7), dtype=np.float32)
    true_xi[:, 0] = np.arange(n) * 0.5  # x translation
    S_true = np.asarray(sim3_lie.exp_sim3(jnp.asarray(true_xi)))
    # drifted estimate: growing error
    drift = np.zeros((n, 7), dtype=np.float32)
    drift[:, 1] = np.arange(n) * 0.05
    drift[:, 6] = np.arange(n) * 0.01  # scale drift
    S_est = np.asarray(sim3_lie.exp_sim3(jnp.asarray(true_xi + drift)))

    # odometry edges from the DRIFTED estimate (consistent, so zero residual
    # initially), plus one loop edge with the TRUE relative pose
    edge_i, edge_j, S_meas, w = [], [], [], []
    for k in range(n - 1):
        edge_i.append(k)
        edge_j.append(k + 1)
        S_meas.append(S_est[k + 1] @ np.linalg.inv(S_est[k]))
        w.append(1.0)
    edge_i.append(0)
    edge_j.append(n - 1)
    S_meas.append(S_true[n - 1] @ np.linalg.inv(S_true[0]))
    w.append(10.0)

    fixed = np.zeros(n, dtype=bool)
    fixed[0] = True
    S_opt = optimize_pose_graph(
        jnp.asarray(S_est),
        jnp.asarray(edge_i, dtype=jnp.int32),
        jnp.asarray(edge_j, dtype=jnp.int32),
        jnp.asarray(np.stack(S_meas), dtype=jnp.float32),
        jnp.asarray(w, dtype=jnp.float32),
        jnp.asarray(fixed),
        iterations=30,
    )
    # the last pose must now satisfy the loop constraint
    err_before = np.linalg.norm(S_est[n - 1] - S_true[n - 1])
    err_after = np.linalg.norm(np.asarray(S_opt[n - 1]) - S_true[n - 1])
    assert err_after < 0.1 * err_before
