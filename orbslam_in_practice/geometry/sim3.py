"""Closed-form absolute orientation / Sim(3) (Horn's quaternion method).

Intended semantics of the reference's Sim3Solver (src/Sim3Solver.cpp:7-69),
with its defects fixed (SURVEY.md §2.4): the maximum-eigenvalue eigenvector
is selected explicitly (Eigen does sort ascending but the reference took
col(0), the minimum), the quaternion convention is (w, x, y, z), and the
results are actually returned.

Used by: loop-closing Sim3 RANSAC, EPnP's final absolute-orientation step,
and ATE evaluation alignment.
"""

from __future__ import annotations

import jax.numpy as jnp

from orbslam_in_practice.geometry.se3 import quat_to_rot


def horn_sim3(
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    w: jnp.ndarray | None = None,
    with_scale: bool = True,
) -> tuple:
    """Closed-form similarity p2 ≈ s R p1 + t.

    Args:
      p1, p2: (..., N, 3) corresponding 3D point sets.
      w: optional (..., N) weights / mask.
      with_scale: if False returns s = 1 (rigid SE3, used for ATE on KITTI
        stereo-style eval and EPnP absolute orientation).

    Returns:
      (s (...,), R (..., 3, 3), t (..., 3)).
    """
    if w is None:
        w = jnp.ones(p1.shape[:-1], dtype=p1.dtype)
    w = w.astype(p1.dtype)
    n = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-12)
    c1 = jnp.sum(p1 * w[..., None], axis=-2) / n
    c2 = jnp.sum(p2 * w[..., None], axis=-2) / n
    q1 = (p1 - c1[..., None, :]) * w[..., None]
    q2 = (p2 - c2[..., None, :]) * w[..., None]

    # M = sum q1_i q2_i^T  (correlation of centered sets)
    M = jnp.einsum("...ni,...nj->...ij", q1, q2)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    # Horn's 4x4 symmetric N matrix
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        axis=-2,
    )
    vals, vecs = jnp.linalg.eigh(N)
    quat = vecs[..., :, -1]  # max eigenvalue -> optimal rotation (w, x, y, z)
    R = quat_to_rot(quat)

    if with_scale:
        # asymmetric scale (Horn eq. 40, matches ref intent :56-65):
        # s = sum <q2, R q1> / sum ||q1||^2  — weights already folded in; the
        # double w fold cancels in the ratio's first order and keeps masked
        # points at exactly zero contribution.
        Rq1 = jnp.einsum("...ij,...nj->...ni", R, q1)
        num = jnp.sum(q2 * Rq1, axis=(-1, -2))
        den = jnp.sum(q1 * q1, axis=(-1, -2))
        s = num / jnp.maximum(den, 1e-12)
    else:
        s = jnp.ones(p1.shape[:-2], dtype=p1.dtype)
    t = c2 - s[..., None] * jnp.einsum("...ij,...j->...i", R, c1)
    return s, R, t
