"""Pose-only bundle adjustment (motion-only BA).

Intended semantics of the reference's PoseOptimization
(src/Optimizer.cpp:131-261): one SE3 vertex, N monocular reprojection edges,
Huber kernel delta = sqrt(5.991), 4 rounds x 10 LM iterations; after each
round edges with chi2 > 5.991 are excluded (and re-included if they recover),
and the robust kernel is dropped for the final rounds. Fixes the reference's
defects: per-octave information matrices actually set (ref :185-186 left
invSigma unset), correct intrinsic indexing (ref :134-139 read cx/cy from the
wrong K entries).

Design: analytic 2x6 Jacobians, batched over all edges; the whole
4-round schedule is a single jitted computation with lax.fori_loop — no
dynamic shapes, outliers handled by masking.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from orbslam_in_practice.geometry.se3 import exp_se3, hat

CHI2_MONO = 5.991
# plain float (a module-level jnp op would initialize the XLA backend at
# import time, breaking jax.distributed.initialize in multi-process runs)
HUBER_DELTA = CHI2_MONO**0.5


def _residual_jacobian(Tcw, Xw, uv, K):
    """Residuals r = uv - proj (N, 2) and Jacobians wrt left-perturbation of
    Tcw tangent [rho, phi] (N, 2, 6); also camera-frame depth (N,)."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = Xw @ R.T + t  # (N, 3)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * x / z_safe + cx
    v = fy * y / z_safe + cy
    r = uv - jnp.stack([u, v], axis=-1)  # (N, 2)

    # d(proj)/d(pc)
    zi = 1.0 / z_safe
    zi2 = zi * zi
    J_proj = jnp.stack(
        [
            jnp.stack([fx * zi, jnp.zeros_like(zi), -fx * x * zi2], axis=-1),
            jnp.stack([jnp.zeros_like(zi), fy * zi, -fy * y * zi2], axis=-1),
        ],
        axis=-2,
    )  # (N, 2, 3)
    # d(pc)/d(xi) with xi = [rho, phi], left multiply: pc' = pc + rho + phi x pc
    dpc = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3, dtype=Tcw.dtype), pc.shape[:-1] + (3, 3)), -hat(pc)],
        axis=-1,
    )  # (N, 3, 6)
    # r = obs - proj, so dr/dxi = -J_proj @ dpc
    J = -J_proj @ dpc  # (N, 2, 6)
    return r, J, z


def _chi2(r, inv_sigma2):
    return jnp.sum(r * r, axis=-1) * inv_sigma2


@partial(jax.jit, static_argnames=("rounds", "iters_per_round"))
def pose_optimization(
    Tcw0: jnp.ndarray,
    Xw: jnp.ndarray,
    uv: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    valid: jnp.ndarray,
    K: jnp.ndarray,
    rounds: int = 4,
    iters_per_round: int = 10,
):
    """Optimize a single camera pose against fixed 3D points.

    Args:
      Tcw0: (4, 4) initial world->camera pose.
      Xw: (N, 3) map points (fixed).
      uv: (N, 2) undistorted pixel observations.
      inv_sigma2: (N,) per-observation information (1/sigma^2 per octave).
      valid: (N,) bool — observation exists.
      K: (3, 3) intrinsics.

    Returns:
      (Tcw, inlier_mask (N,), n_inliers) — matching the reference's contract
      of scrubbing outliers after optimization (src/Tracking.cpp:312-327).
    """
    dtype = Tcw0.dtype
    inlier = valid

    def lm_round(Tcw, inlier, use_huber):
        w_mask = inlier.astype(dtype)

        def rho_cost(chi2):
            if not use_huber:
                return chi2
            d2 = HUBER_DELTA * HUBER_DELTA
            return jnp.where(
                chi2 <= d2, chi2, 2.0 * HUBER_DELTA * jnp.sqrt(chi2) - d2
            )

        def iter_body(state):
            Tcw, lam, last_err, it, _ = state
            r, J, z = _residual_jacobian(Tcw, Xw, uv, K)
            chi2 = _chi2(r, inv_sigma2)
            if use_huber:
                # IRLS Huber weight: min(1, delta / |r|_Sigma)
                wh = jnp.minimum(1.0, HUBER_DELTA / jnp.sqrt(jnp.maximum(chi2, 1e-12)))
            else:
                wh = jnp.ones_like(chi2)
            w = w_mask * inv_sigma2 * wh  # (N,)
            # normal equations as matmuls: A = sqrt(w) J flattened (2N, 6)
            sw = jnp.sqrt(w)[:, None]
            A = (J * sw[..., None]).reshape(-1, 6)
            b = (r * sw).reshape(-1)
            # HIGHEST: keeps these f32 products off TF32, whose ~1e-3
            # relative rounding floors the achievable pose accuracy; these
            # products are tiny (2Nx6), so full f32 costs nothing
            H = jnp.matmul(A.T, A, precision=lax.Precision.HIGHEST)
            g = -jnp.matmul(b, A, precision=lax.Precision.HIGHEST)
            H_damped = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6, dtype=dtype)
            delta = jnp.linalg.solve(H_damped, g)
            Tcw_new = exp_se3(delta) @ Tcw
            r_new, _, _ = _residual_jacobian(Tcw_new, Xw, uv, K)
            chi2_new = _chi2(r_new, inv_sigma2)
            err_new = jnp.sum(rho_cost(chi2_new) * w_mask)
            err_old = jnp.sum(rho_cost(chi2) * w_mask)
            accept = err_new < err_old
            Tcw = jnp.where(accept, Tcw_new, Tcw)
            lam = jnp.where(accept, lam * 0.5, lam * 4.0)
            err = jnp.where(accept, err_new, err_old)
            # converged: step accepted with a vanishing update, or rejected
            # with a tiny prospective improvement
            done = jnp.sum(delta * delta) < 1e-12
            return Tcw, lam, err, it + 1, done

        def cond(state):
            _, _, _, it, done = state
            return (it < iters_per_round) & (~done)

        init = (
            Tcw,
            jnp.asarray(1e-3, dtype),
            jnp.asarray(jnp.inf, dtype),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
        )
        Tcw, _, _, _, _ = lax.while_loop(cond, iter_body, init)
        return Tcw

    Tcw = Tcw0
    for rnd in range(rounds):
        # robust kernel active for all but the LAST round (the reference
        # disables it after round 3 of 4 — src/Optimizer.cpp:242-243: by the
        # final round the chi2 gating has scrubbed the gross outliers, so the
        # last round runs plain Gauss weights for an unbiased refinement)
        use_huber = rnd < rounds - 1
        Tcw = lm_round(Tcw, inlier, use_huber)
        # re-gate ALL valid edges (allows re-inclusion, ref :211-247)
        r, _, z = _residual_jacobian(Tcw, Xw, uv, K)
        chi2 = _chi2(r, inv_sigma2)
        inlier = valid & (chi2 <= CHI2_MONO) & (z > 0)

    return Tcw, inlier, jnp.sum(inlier)
