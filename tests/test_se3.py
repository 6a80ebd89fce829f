import jax.numpy as jnp
import numpy as np

from orbslam_in_practice.geometry import se3


def random_rotation(rng, n=()):
    w = rng.normal(size=n + (3,)) * 1.5
    return np.asarray(se3.exp_so3(jnp.asarray(w, dtype=jnp.float32)))


def test_exp_log_so3_roundtrip(rng):
    # keep |w| < pi: log is only the inverse of exp inside the principal ball
    direction = rng.normal(size=(64, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    mag = rng.uniform(0.01, 2.8, size=(64, 1))
    w = jnp.asarray(direction * mag, dtype=jnp.float32)
    R = se3.exp_so3(w)
    # orthonormal, det +1
    eye = jnp.eye(3)
    err = jnp.max(jnp.abs(jnp.swapaxes(R, -1, -2) @ R - eye))
    assert err < 1e-5
    assert np.allclose(np.linalg.det(np.asarray(R)), 1.0, atol=1e-5)
    w2 = se3.log_so3(R)
    assert np.allclose(np.asarray(w), np.asarray(w2), atol=1e-4)


def test_exp_log_so3_small_angle():
    w = jnp.asarray([[1e-9, 0, 0], [0.0, 0.0, 0.0]], dtype=jnp.float32)
    R = se3.exp_so3(w)
    assert np.allclose(np.asarray(R[1]), np.eye(3), atol=1e-7)
    assert np.all(np.isfinite(np.asarray(se3.log_so3(R))))


def test_exp_log_se3_roundtrip(rng):
    xi = jnp.asarray(rng.normal(size=(32, 6)), dtype=jnp.float32)
    T = se3.exp_se3(xi)
    xi2 = se3.log_se3(T)
    assert np.allclose(np.asarray(xi), np.asarray(xi2), atol=1e-4)


def test_se3_inverse_compose(rng):
    xi = jnp.asarray(rng.normal(size=(8, 6)), dtype=jnp.float32)
    T = se3.exp_se3(xi)
    I = se3.se3_compose(T, se3.se3_inverse(T))
    assert np.allclose(np.asarray(I), np.broadcast_to(np.eye(4), (8, 4, 4)), atol=1e-5)


def test_transform_points(rng):
    R = jnp.asarray(random_rotation(rng), dtype=jnp.float32)
    t = jnp.asarray(rng.normal(size=3), dtype=jnp.float32)
    T = se3.make_se3(R, t)
    pts = jnp.asarray(rng.normal(size=(10, 3)), dtype=jnp.float32)
    out = se3.transform_points(T, pts)
    expect = pts @ np.asarray(R).T + np.asarray(t)
    assert np.allclose(np.asarray(out), expect, atol=1e-5)


def test_quat_rot_roundtrip(rng):
    R = jnp.asarray(random_rotation(rng, (64,)), dtype=jnp.float32)
    q = se3.rot_to_quat(R)
    R2 = se3.quat_to_rot(q)
    assert np.allclose(np.asarray(R), np.asarray(R2), atol=1e-5)
    # canonical sign
    assert np.all(np.asarray(q[..., 0]) >= -1e-7)


def test_quat_rot_near_pi(rng):
    # rotations near pi exercise the non-trace quaternion branches
    axis = rng.normal(size=(16, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    w = jnp.asarray(axis * (np.pi - 1e-3), dtype=jnp.float32)
    R = se3.exp_so3(w)
    q = se3.rot_to_quat(R)
    R2 = se3.quat_to_rot(q)
    assert np.allclose(np.asarray(R), np.asarray(R2), atol=1e-4)
