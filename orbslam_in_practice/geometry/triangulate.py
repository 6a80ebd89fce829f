"""DLT triangulation, batched, eigh-based (no SVD needed).

Implements the intended semantics of the reference's Triangulate
(src/Initializer.cpp:617-635): the classic 4x4 DLT system whose solution is
the null vector of A. We solve via eigh(A^T A) — a batched symmetric
eigendecomposition of 4x4 matrices is cheaper than a general SVD and is
exact for the smallest eigenvector.
"""

from __future__ import annotations

import jax.numpy as jnp


def triangulate_dlt(
    P1: jnp.ndarray, P2: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray
) -> jnp.ndarray:
    """Triangulate points from two views.

    Args:
      P1, P2: (..., 3, 4) projection matrices (K [R|t]).
      x1, x2: (..., 2) pixel observations in each view.

    Returns:
      (..., 3) world points (homogeneous solution dehomogenized).
    """
    rows = [
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = jnp.stack(rows, axis=-2)  # (..., 4, 4)
    # Row-normalize for conditioning in f32.
    A = A / jnp.maximum(jnp.linalg.norm(A, axis=-1, keepdims=True), 1e-12)
    AtA = jnp.swapaxes(A, -1, -2) @ A
    _, vecs = jnp.linalg.eigh(AtA)
    X = vecs[..., :, 0]  # smallest eigenvalue's eigenvector
    w = X[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]
